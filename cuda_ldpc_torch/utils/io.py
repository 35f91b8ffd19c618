"""Text parser for the reference's BlockH base-matrix files (counterpart of
cuda_ldpc_tpu/utils/io.py:25-67; the GF(q) and constellation parsers come
with the GF(q) slice).

BlockH base matrices: J*L whitespace-separated ints, -1 = all-zero block,
else circulant right-shift (parsed by bldpc_实习/Simulation.cu:292-354).
Dimensions come from the filename pattern ``J{J}_L{L}_Z{Z}_BlockH.txt`` or are
given explicitly (the reference hardcodes them in define.cuh).
"""

from __future__ import annotations

import re

import numpy as np

_BLOCKH_NAME = re.compile(r"J(\d+)_L(\d+)_Z(\d+)_BlockH")


def _scan_ints(path: str) -> np.ndarray:
    """All integer tokens of a pure-numeric file as one flat int64 array.
    Uses the native C scanner (native/ldpc_host.cpp ref_scan_ints — the
    reference parses these files with fscanf loops) when the library is
    built, else a NumPy text parse."""
    try:
        from cuda_ldpc_torch.utils import native
        if native.available():
            return native.scan_ints(path)
    except Exception:
        pass
    with open(path) as f:
        return np.array(f.read().split(), dtype=np.int64)


def infer_blockh_dims(filename: str) -> tuple[int, int, int] | None:
    m = _BLOCKH_NAME.search(filename)
    if m:
        j, l, z = (int(g) for g in m.groups())
        return j, l, z
    return None


def parse_blockh(path: str, J: int | None = None, L: int | None = None,
                 Z: int | None = None) -> tuple[np.ndarray, int]:
    """Read a BlockH base matrix file -> (base[J, L] int array, Z)."""
    dims = infer_blockh_dims(path)
    if dims is not None:
        J = J if J is not None else dims[0]
        L = L if L is not None else dims[1]
        Z = Z if Z is not None else dims[2]
    if J is None or L is None or Z is None:
        raise ValueError(f"cannot infer (J, L, Z) for {path}; pass them explicitly")
    vals = _scan_ints(path)
    if vals.size != J * L:
        raise ValueError(f"{path}: expected {J}*{L}={J*L} entries, got {vals.size}")
    base = vals.reshape(J, L)
    if np.any((base < -1) | (base >= Z)):
        raise ValueError(f"{path}: shifts must be in [-1, {Z})")
    return base, Z
