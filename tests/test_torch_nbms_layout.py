"""The layout of K8's full-EMS check row (csrc/nbms.cu ``maxconvs`` and
``ems_full_row``) on the CPU.

``maxconvs`` spreads the (max,+) convolutions out[x] = max_u A[u] + B[u ^ x]
of a phase over a row group's threads.  A unit is a tile of 4 outputs x0 + k
of one job and one of S interleaved parts of the 4-symbol u tiles u0 = 4 t;
it reads A[u0 + i] and B[(u0 ^ x0) + (i ^ k)].  S is the largest power of 2
up to 32 and q / 4 whose njobs * q / 4 * S units fit the group's threads,
and the parts' maxima meet by shuffles.  A torch emulation of that mapping
(each unit's terms gathered by the kernel's indices, its maximum taken over
its part's tiles, then over the parts) must equal nb_decode's ``_maxconv``
bit for bit, and the row's wiring (U, the forward and backward chains from
the identity two jobs at a time, the exclusive convolutions over U, the
output) ``_ems_full_cn_core``.  Tolerance: none: each term is one add and
a maximum is exact.  Inputs are seeded numpy.  No JAX here: the plain core
is held to the JAX package by tests/test_torch_nb_maxdomain.py.
"""

import functools

import numpy as np
import pytest
import torch

from cuda_ldpc_torch import NBCode
from cuda_ldpc_torch.ops import nb_decode


def split(q: int, nth: int, njobs: int) -> int:
    """S, the parts of the u tiles a unit takes (csrc/nbms.cu maxconvs)."""
    tiles, S = q // 4, 1
    while 2 * S <= 32 and 2 * S <= tiles and 2 * S * njobs * tiles <= nth:
        S *= 2
    return S


def maxconvs(A: torch.Tensor, B: torch.Tensor, nth: int) -> torch.Tensor:
    """A, B [..., njobs, q] -> out [..., njobs, q] through maxconvs' units
    on a group of ``nth`` threads."""
    njobs, q = A.shape[-2:]
    tiles = q // 4
    S = split(q, nth, njobs)
    t = torch.arange(tiles)
    i = torch.arange(4)
    a = A[..., 4 * t[:, None] + i]                       # [.., tu, i]
    u0x0 = (4 * t)[None, :] ^ (4 * t)[:, None]          # [tx, tu]
    b = B[..., u0x0[:, :, None, None] + (i[:, None] ^ i[None, :])]
    terms = a[..., None, :, :, None] + b                # [.., tx, tu, i, k]
    parts = [terms[..., part::S, :, :].amax(dim=(-3, -2))
             for part in range(S)]                      # S x [.., tx, k]
    out = functools.reduce(torch.maximum, parts)
    return out.reshape(out.shape[:-2] + (q,))


def _identity(q: int) -> torch.Tensor:
    return torch.where(torch.arange(q) == 0, 0.0, nb_decode.NEG)


@pytest.mark.parametrize("q,dc,splits", [
    (64, 4, (4, 2)),      # BDS.576.288.GF.64: chains S = 4, excl S = 2
    (256, 4, (1, 1)),     # LDPC_N96_K48_GF256_d1_exp
    (256, 12, (2, 1)),    # LDPC_N576_K480_GF256_exp (excl: two rounds)
    (32, 3, (4, 4)),
])
def test_units_equal_the_plain_maxconv(q, dc, splits):
    """Each phase's units, against ``_maxconv`` on the same operands,
    the identity among them; S for the chains (2 jobs) and for the
    exclusive convolutions (dc jobs)."""
    nth = 32 * dc
    assert (split(q, nth, 2), split(q, nth, dc)) == splits
    rng = np.random.default_rng(q + dc)
    for njobs in (2, dc):
        A = torch.from_numpy(rng.normal(0, 6, (3, njobs, q)).astype(np.float32))
        B = torch.from_numpy(rng.normal(0, 6, (3, njobs, q)).astype(np.float32))
        A[0, 0] = _identity(q)
        B[1, -1] = _identity(q)
        assert torch.equal(maxconvs(A, B, nth), nb_decode._maxconv(A, B))


@pytest.mark.parametrize("name", ["BDS.576.288.GF.64",
                                  "LDPC_N576_K288_GF64_d1_exp",
                                  "LDPC_N96_K48_GF256_d1_exp"])
def test_row_wiring_equals_the_plain_row(name):
    """ems_full_row: U over X, fwd[0] and bwd[dc - 1] the identity, one
    step of each chain a phase (fwd in Y, bwd in A), the exclusive
    convolutions over X, then c2v[k] = (X[h k] - X[0]) * f32(1/1.2), the
    kernel's index h ? h k : 0 (LDPC_N576_K288_GF64_d1_exp has two
    coefficient-0 edges)."""
    code = NBCode.from_registry(name)
    g = nb_decode.build_graph(code)
    q, dc, nth = g.q, g.dc, 32 * g.dc
    h_perm = torch.as_tensor(g.h_perm)
    mask = torch.as_tensor(g.cn_mask)
    rng = np.random.default_rng(dc * q)
    v2c = torch.from_numpy(rng.normal(0, 4, (2, g.M, dc, q)).astype(np.float32))
    X = nb_decode._to_cn_domain(v2c, h_perm)             # [B, M, dc, q]
    ident = _identity(q).expand(X[:, :, 0].shape)
    Y, A = [ident], [ident]                              # fwd, bwd reversed
    for s in range(dc - 1):
        d = dc - 1 - s
        out = maxconvs(torch.stack([Y[-1], A[-1]], dim=2),
                       torch.stack([X[:, :, s], X[:, :, d]], dim=2), nth)
        Y.append(out[:, :, 0])
        A.append(out[:, :, 1])
    Y, A = torch.stack(Y, dim=2), torch.stack(A[::-1], dim=2)
    X = maxconvs(Y, A, nth)                              # excl over U
    idx = torch.where(h_perm[..., 1:2] != 0, h_perm, 0)
    out = torch.gather(X, -1, idx[None].expand(X.shape))
    c2v = (out - X[..., :1]) * nb_decode.EMS_SCALE
    plain = nb_decode._ems_full_cn_core(v2c, mask, h_perm, dc, q)
    assert bool((h_perm[..., 1] == 0).any()) == (
        name == "LDPC_N576_K288_GF64_d1_exp")
    assert torch.equal(c2v, plain)
