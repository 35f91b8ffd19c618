"""GF(2^m) arithmetic tables, computed from primitive polynomials
(counterpart of cuda_ldpc_tpu/utils/gf.py:1-75, a numpy copy of the tables;
its element-wise helpers and the reader of the reference's shipped table
files have no caller in the port).

The CUDA reference ships the tables as text files
(myNBLDPC/GF/Arith.Table.GF.<q>.txt, loaded by myNBLDPC/src/GF.cpp:68-117);
they are computed here from the same primitive polynomials (each file's
header names its polynomial).  Addition over GF(2^m) is XOR (GF.cpp:48-51);
multiplication and inversion use log/antilog tables.
"""

from __future__ import annotations

import functools

import numpy as np

# Primitive polynomials, verbatim from the shipped table headers
# (e.g. "GF(64) with Primitive Polynomial: 67.").
PRIMITIVE_POLY: dict[int, int] = {
    4: 7,        # x^2+x+1
    8: 11,       # x^3+x+1
    16: 19,      # x^4+x+1
    32: 37,      # x^5+x^2+1
    64: 67,      # x^6+x+1
    128: 137,    # x^7+x^3+1
    256: 285,    # x^8+x^4+x^3+x^2+1
    512: 529,    # x^9+x^4+1
}


@functools.lru_cache(maxsize=None)
def exp_log_tables(q: int) -> tuple[np.ndarray, np.ndarray]:
    """Antilog/log tables for GF(q): exp[i] = alpha^i, log[exp[i]] = i."""
    poly = PRIMITIVE_POLY[q]
    exp = np.zeros(q - 1, dtype=np.int64)
    log = np.zeros(q, dtype=np.int64)
    x = 1
    for i in range(q - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & q:
            x ^= poly
    if x != 1:
        raise ValueError(f"polynomial {poly} is not primitive for GF({q})")
    return exp, log


@functools.lru_cache(maxsize=None)
def mul_table(q: int) -> np.ndarray:
    """Full q x q multiplication table (row/col indexed by field element)."""
    exp, log = exp_log_tables(q)
    a = np.arange(q)
    la, lb = np.meshgrid(log[a], log[a], indexing="ij")
    out = exp[(la + lb) % (q - 1)]
    out[0, :] = 0
    out[:, 0] = 0
    return out.astype(np.int64)


@functools.lru_cache(maxsize=None)
def inv_table(q: int) -> np.ndarray:
    """Multiplicative inverse per element; inv[0] = 0 (the reference aborts on
    division by zero, GF.cpp:60-64 — our callers never index 0)."""
    exp, log = exp_log_tables(q)
    out = np.zeros(q, dtype=np.int64)
    nz = np.arange(1, q)
    out[nz] = exp[(q - 1 - log[nz]) % (q - 1)]
    return out


@functools.lru_cache(maxsize=None)
def xor_table(q: int) -> np.ndarray:
    """q x q XOR (= GF addition) table."""
    a = np.arange(q)
    return (a[:, None] ^ a[None, :]).astype(np.int64)
