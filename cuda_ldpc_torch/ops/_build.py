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
    lib.ldpc_bp_flooding.argtypes = (
        [p] * 12                  # chan T R hard ok ctl + 6 edge tables
        + [i] * 6                 # B L J E Z num_iters
        + [f, i, f, i]            # alpha use_alpha beta use_beta
        + [i, i, i, i, i, p])     # check early_stop max_dc bf16 device stream
    lib.ldpc_bp_flooding.restype = i
    lib.ldpc_bp_layered.argtypes = (
        [p] * 10                  # chan T R hard ok ctl + 4 edge tables
        + [i] * 6                 # B L J E Z num_iters
        + [f, i, f, i]            # alpha use_alpha beta use_beta
        + [i, i, i, i, i, p])     # check early_stop max_dc bf16 device stream
    lib.ldpc_bp_layered.restype = i
    for batch in (lib.ldpc_minsum_flooding, lib.ldpc_minsum_layered):
        batch.argtypes = (
            [p] * 17              # chan tsave hard ok kb sv sm ctl + 6 edge
                                  # tables + edge_row edge_pos plan
            + [i] * 6             # B L J E Z num_iters
            + [f, i, f, i]        # alpha use_alpha beta use_beta
            + [i] * 8             # check early_stop cluster smem_bytes wide
                                  # threads bf16 device
            + [p])                # stream
        batch.restype = i
    lib.ldpc_minsum_stream_global.argtypes = (
        [p] * 13                  # chan T R hard t done okf + 6 edge tables
        + [i] * 7                 # B L J E Z k max_iters
        + [f, i, f, i]            # alpha use_alpha beta use_beta
        + [i, i, i, i, i, p])     # check rule layered max_dc device stream
    lib.ldpc_minsum_stream_global.restype = i
    lib.ldpc_minsum_stream.argtypes = (
        [p] * 15                  # chan R hard t done okf + 6 edge tables +
                                  # edge_row edge_pos plan
        + [i] * 7                 # B L J E Z k max_iters
        + [f, i, f, i]            # alpha use_alpha beta use_beta
        + [i] * 7                 # check layered cluster smem_bytes wide
                                  # threads device
        + [p])                    # stream
    lib.ldpc_minsum_stream.restype = i
    lib.ldpc_qspa_stream.argtypes = (
        [p] * 15                  # chan C hard t done okf + 5 edge tables +
                                  # gf_log gf_exp + wave_ptr wave_row
        + [i] * 12                # nwaves groups B N M E q max_dc k
                                  # max_iters layered device
        + [p])                    # stream
    lib.ldpc_qspa_stream.restype = i
    lib.ldpc_qspa.argtypes = (
        [p] * 14                  # chan C hard ok iters + 5 edge tables +
                                  # gf_log gf_exp + wave_ptr wave_row
        + [i] * 11                # nwaves layout width B N M E q max_dc
                                  # num_iters layered
        + [i, p])                 # device stream
    lib.ldpc_qspa.restype = i
    lib.ldpc_qspa_blocks_per_sm.argtypes = [i] * 8  # q layered layout width
    lib.ldpc_qspa_blocks_per_sm.restype = i         # N E max_dc device
    lib.ldpc_qspa_qc.argtypes = (
        [p] * 15                  # chan T C hard ok iters + 7 block tables +
                                  # gf_log gf_exp
        + [i] * 10                # B NB MB lz EB q max_dc num_iters layered
                                  # device
        + [p])                    # stream
    lib.ldpc_qspa_qc.restype = i
    lib.ldpc_qspa_qc_global.argtypes = (
        [p] * 14                  # chan T C hard ok iters + 6 block tables +
                                  # gf_log gf_exp
        + [i] * 10                # B NB MB Z EB q max_dc num_iters layered
                                  # device
        + [p])                    # stream
    lib.ldpc_qspa_qc_global.restype = i
    lib.ldpc_nbms.argtypes = (
        [p] * 14                  # chan C hard ok iters + 5 edge tables +
                                  # gf_log gf_exp + wave_ptr wave_row
        + [i] * 12                # nwaves groups B N M E q max_dc
                                  # num_iters method nm nc
        + [p, i]                  # scratch grid
        + [i, p])                 # device stream
    lib.ldpc_nbms.restype = i
    for occupancy in (lib.ldpc_nbms_blocks_per_sm,
                      lib.ldpc_qspa_stream_blocks_per_sm):
        occupancy.argtypes = [i] * 6  # q method|layered groups N max_dc
        occupancy.restype = i         # device
    lib.ldpc_probe_bitops.argtypes = (
        [p] * 2                   # x out
        + [i] * 4                 # rows cols fn device
        + [p])                    # stream
    lib.ldpc_probe_bitops.restype = i
    lib.ldpc_probe_mosaic.argtypes = (
        [p] * 3                   # x extra out
        + [i] * 5                 # Q TB Z fn device
        + [p])                    # stream
    lib.ldpc_probe_mosaic.restype = i
    lib.ldpc_probe_mosaic_roll2.argtypes = [p, p, i, i, i, p]  # x out rows
    lib.ldpc_probe_mosaic_roll2.restype = i                   # Z device stream
    lib.ldpc_probe_oprate.argtypes = (
        [p] * 2                   # x out
        + [i] * 5                 # rows cols copies op n_par
        + [ctypes.c_longlong, i, p])   # K device stream
    lib.ldpc_probe_oprate.restype = i
    lib.ldpc_probe_oprate_blocks_per_sm.argtypes = [i] * 4  # op n_par cols
    lib.ldpc_probe_oprate_blocks_per_sm.restype = i         # device
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
