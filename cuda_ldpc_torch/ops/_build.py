"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use by its own ``nvcc``, all of
them at once, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the build
takes seconds rather than minutes).  The library lands in
``cuda_ldpc_torch/build/<hash>/``, keyed by a hash of the sources and the
flags, so an edited source is rebuilt and a stale library is never loaded.
A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

_PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "build"
LIB_NAME = "libcuda_ldpc_torch.so"

# No --use_fast_math: the kernels must match the plain PyTorch versions bit
# for bit.  -Xptxas -v records registers and spills in build.log.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> pathlib.Path:
    return BUILD_DIR / source_hash() / LIB_NAME


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def compile_command(src: pathlib.Path, obj: pathlib.Path,
                    compiler: str = "nvcc") -> list[str]:
    return [compiler, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs: list[pathlib.Path], out: pathlib.Path,
                 compiler: str = "nvcc") -> list[str]:
    return [compiler, "-shared", "-o", str(out), *(str(o) for o in objs)]


def build() -> pathlib.Path:
    """Compile the library if this source hash has none yet; return its
    path.  Every source gets its own nvcc, all started together; the link
    follows.  Concurrent builds each write private files and rename the
    library into place."""
    path = lib_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    # nvcc reads a file's kind from its suffix, so the objects end in .o
    objs = [path.with_name(f"{src.stem}.{os.getpid()}.o") for src in sources()]
    procs = [subprocess.Popen(compile_command(src, obj, exe),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources(), objs)]
    logs = [f"$ {' '.join(p.args)}\n{p.communicate()[0]}" for p in procs]
    failed = [p for p in procs if p.returncode != 0]
    tmp = path.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(link_command(objs, tmp, exe),
                              capture_output=True, text=True)
        logs.append(f"$ {' '.join(link.args)}\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(link)
    log = "\n".join(logs)
    (path.parent / "build.log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0].returncode}):\n{log}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldpc_minsum_flooding.argtypes = (
        [p] * 12                  # chan T R hard ok ctl + 6 edge tables
        + [i] * 6                 # B L J E Z num_iters
        + [f, i, f, i]            # alpha use_alpha beta use_beta
        + [i, i, i, i, p])        # check early_stop rule device stream
    lib.ldpc_minsum_flooding.restype = i
    lib.ldpc_minsum_layered.argtypes = (
        [p] * 10                  # chan T R hard ok ctl + 4 edge tables
        + [i] * 6                 # B L J E Z num_iters
        + [f, i, f, i]            # alpha use_alpha beta use_beta
        + [i, i, i, i, p])        # check early_stop rule device stream
    lib.ldpc_minsum_layered.restype = i
    lib.ldpc_error_string.argtypes = [i]
    lib.ldpc_error_string.restype = ctypes.c_char_p
    lib.ldpc_max_row_degree.argtypes = []
    lib.ldpc_max_row_degree.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(str(build())))
    return _lib
