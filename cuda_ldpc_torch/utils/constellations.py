"""Constellation generation (BPSK, Gray 64/256-QAM), computed rather than
file-loaded (counterpart of cuda_ldpc_tpu/utils/constellations.py, a numpy
copy).

The reference ships text files
(myNBLDPC/Constellation/{BPSK,GRAY_64QAM,GRAY_256QAM}.txt) parsed at startup
(Simulation.cpp:313-338).  Structure of those files: each axis of the square
QAM uses reflected-Gray PAM with the axis sign taken from the axis MSB
(0 -> +, 1 -> -, mirrored on the real axis), magnitude = (M-1) -
2*gray2bin(rest), unit average symbol energy (1/sqrt(42) for 64-QAM,
1/sqrt(170) for 256-QAM).  Point index convention: high bits select the real
level, low bits the imaginary.
"""

from __future__ import annotations

import functools

import numpy as np


def _gray2bin(g: np.ndarray, bits: int) -> np.ndarray:
    b = g.copy()
    shift = 1
    while shift < bits:
        b ^= b >> shift
        shift *= 2
    return b


def _pam_axis(bits: int) -> np.ndarray:
    """Per-axis level for index n (bits per axis): sign from MSB, Gray
    magnitude."""
    n = np.arange(1 << bits)
    sign = np.where(n < (1 << (bits - 1)), 1.0, -1.0)
    mag_idx = _gray2bin(n & ((1 << (bits - 1)) - 1), bits - 1)
    mmax = (1 << bits) - 1
    return sign * (mmax - 2 * mag_idx)


@functools.lru_cache(maxsize=None)
def constellation(n_qam: int) -> np.ndarray:
    """complex[n_qam] points indexed by label, matching the reference files."""
    if n_qam == 2:
        return np.array([1.0 + 0j, -1.0 + 0j])
    bits = int(np.log2(n_qam))
    if 1 << bits != n_qam or bits % 2:
        raise ValueError(f"unsupported constellation order {n_qam}")
    ax = bits // 2
    levels = _pam_axis(ax)
    scale = 1.0 / np.sqrt(2.0 * np.sum((np.arange(1, 1 << ax, 2)) ** 2)
                          / (1 << (ax - 1)))
    idx = np.arange(n_qam)
    re = -levels[idx >> ax] * scale   # real axis is mirrored in the shipped files
    im = levels[idx & ((1 << ax) - 1)] * scale
    return re + 1j * im
