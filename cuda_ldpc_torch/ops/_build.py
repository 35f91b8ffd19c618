"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use by ``nvcc`` into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so the build takes seconds rather than minutes).  The library lands in
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def build_command(out: pathlib.Path, compiler: str = "nvcc") -> list[str]:
    return [compiler, *NVCC_FLAGS, "-o", str(out),
            *(str(p) for p in sources())]


def build() -> pathlib.Path:
    """Compile the library if this source hash has none yet; return its
    path.  Concurrent builds each write a private file and rename it."""
    path = lib_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    proc = subprocess.run(build_command(tmp, nvcc()), capture_output=True,
                          text=True)
    (path.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldpc_minsum_flooding.argtypes = (
        [p] * 12                  # chan T R hard ok ctl + 6 edge tables
        + [i] * 6                 # B L J E Z num_iters
        + [f, i, f, i]            # alpha use_alpha beta use_beta
        + [i, i, i, p])           # check early_stop device stream
    lib.ldpc_minsum_flooding.restype = i
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
