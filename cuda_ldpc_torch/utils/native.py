"""ctypes bridge to the repository's native host library
(native/libldpc_host.so; counterpart of cuda_ldpc_tpu/utils/native.py, the
binary entry points).

Exposes the reference simulator's deterministic binary channel generator
(3-seed LCG + Box-Muller, bldpc_实习/LDPC_Encoder.cu:25-56) and its integer
file scanner at native speed.  The library is compiled on first use with
``make`` (g++) if missing; when no toolchain is available every entry point
raises and callers fall back to the pure-Python utils/lcg.py implementation.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libldpc_host.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(str(_LIB_PATH))
    i32, i64, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    pi32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.ref_awgn_binary.argtypes = [i32, i32, i32, pu8, i64, i64, f64, pd,
                                    pi32]
    lib.ref_scan_ints.argtypes = [ctypes.c_char_p, pi64, i64]
    lib.ref_scan_ints.restype = i64
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def awgn_binary(codeword: np.ndarray, sigma: float, n_frames: int,
                seeds=(173, 173, 173)):
    """Channel output [cw_len, n_frames] (frame-interleaved, like the
    reference's Channel_Out layout) + final seeds."""
    lib = _load()
    cw = np.ascontiguousarray(codeword, dtype=np.uint8)
    out = np.empty((cw.shape[0], n_frames), dtype=np.float64)
    s = np.empty(3, dtype=np.int32)
    lib.ref_awgn_binary(seeds[0], seeds[1], seeds[2], cw, cw.shape[0],
                        n_frames, sigma, out.reshape(-1), s)
    return out, tuple(int(x) for x in s)


def scan_ints(path: str, max_out: int | None = None) -> np.ndarray:
    """All integer tokens of a pure-numeric code-definition file (BlockH),
    parsed at native speed (the reference loads these with fscanf loops,
    bldpc_实习/Simulation.cu:292-354).  Grows the buffer if the first guess
    (file_size/2 tokens) is too small."""
    lib = _load()
    cap = max_out if max_out is not None else max(os.path.getsize(path) // 2,
                                                  1024)
    while True:
        out = np.empty(cap, dtype=np.int64)
        n = lib.ref_scan_ints(path.encode(), out, cap)
        if n < 0:
            raise OSError(f"cannot read {path}")
        if n <= cap:
            return out[:n]
        cap = int(n)
