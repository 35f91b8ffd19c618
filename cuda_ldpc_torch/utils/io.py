"""Text parsers for the reference's code files (counterpart of
cuda_ldpc_tpu/utils/io.py:25-120; the port computes its constellations, so
the constellation-file parser stays with the JAX package's tests).

* BlockH base matrices: J*L whitespace-separated ints, -1 = all-zero block,
  else circulant right-shift (parsed by bldpc_实习/Simulation.cu:292-354).
  Dimensions come from the filename pattern ``J{J}_L{L}_Z{Z}_BlockH.txt`` or
  are given explicitly (the reference hardcodes them in define.cuh).
* Non-binary adjacency files: header ``N M q`` (symbol counts),
  ``maxdv maxdc``, N VN weights, M CN weights, then per-VN (CN index
  1-based, GF coeff) pairs and per-CN (VN index 1-based, GF coeff) pairs
  (myNBLDPC/src/Simulation.cpp:347-467).
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class NBCodeFile:
    """Raw parse of a non-binary adjacency file (1-based indices already
    shifted)."""
    n_sym: int
    m_sym: int
    q: int
    max_dv: int
    max_dc: int
    vn_weight: np.ndarray        # [N]
    cn_weight: np.ndarray        # [M]
    vn_links: np.ndarray         # [N, max_dv] CN index (0-based), -1 pad
    vn_gf: np.ndarray            # [N, max_dv] GF coefficient, 0 pad
    cn_links: np.ndarray         # [M, max_dc] VN index (0-based), -1 pad
    cn_gf: np.ndarray            # [M, max_dc] GF coefficient, 0 pad


def _fill_padded(weights: np.ndarray, pairs: np.ndarray, max_d: int):
    """Scatter per-node (index, coeff) pairs into dense padded [n, max_d]
    tables (links 0-based, -1 pad; coeffs 0 pad) without a Python loop."""
    n = weights.shape[0]
    links = np.full((n, max_d), -1, dtype=np.int64)
    gf = np.zeros((n, max_d), dtype=np.int64)
    rows = np.repeat(np.arange(n), weights)
    starts = np.concatenate(([0], np.cumsum(weights)[:-1]))
    slots = np.arange(weights.sum()) - np.repeat(starts, weights)
    links[rows, slots] = pairs[:, 0] - 1
    gf[rows, slots] = pairs[:, 1]
    return links, gf


def parse_nb_code(path: str) -> NBCodeFile:
    t = _scan_ints(path)
    n_sym, m_sym, q, max_dv, max_dc = (int(x) for x in t[:5])
    pos = 5
    vn_weight = t[pos:pos + n_sym]
    pos += n_sym
    cn_weight = t[pos:pos + m_sym]
    pos += m_sym
    nv = int(vn_weight.sum())
    nc = int(cn_weight.sum())
    if t.size < pos + 2 * nv + 2 * nc:
        raise ValueError(f"{path}: truncated adjacency file "
                         f"({t.size} ints, need {pos + 2 * nv + 2 * nc})")
    vn_links, vn_gf = _fill_padded(vn_weight,
                                   t[pos:pos + 2 * nv].reshape(-1, 2), max_dv)
    pos += 2 * nv
    cn_links, cn_gf = _fill_padded(cn_weight,
                                   t[pos:pos + 2 * nc].reshape(-1, 2), max_dc)
    return NBCodeFile(n_sym, m_sym, q, max_dv, max_dc, vn_weight.copy(),
                      cn_weight.copy(), vn_links, vn_gf, cn_links, cn_gf)
