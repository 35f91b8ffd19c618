"""The layout of K8's full-EMS check row (csrc/nbms.cu ``maxconv_terms``,
``maxconvs``, ``chains`` and ``ems_full_row``) on the CPU.

``maxconv_terms`` spreads the (max,+) convolutions out[x] = max_u A[u] +
B[u ^ x] of a phase over a row group's threads (``maxconvs`` is it with
one term a job).  A unit is a tile of 4 outputs x0 + k of one job and one
of S interleaved parts of the 4-symbol u tiles u0 = 4 t; it reads A[u0 +
i] and B[(u0 ^ x0) + (i ^ k)].  S is the largest power of 2 up to 32 and q
/ 4 whose njobs * q / 4 * S units fit the group's threads, and the parts'
maxima meet by shuffles.  A torch emulation of that mapping (each unit's
terms gathered by the kernel's indices, its maximum taken over its part's
tiles, then over the parts) must equal nb_decode's ``_maxconv`` bit for
bit, and the row's wiring ``_ems_full_cn_core``: U; fwd[1] = 0 + U[0] and
bwd[dc - 2] = 0 + U[dc - 1] (the convolutions with the identity, as
copies); the chains' steps s = 1 .. dc - 2, two jobs a phase; the inner
edges' exclusive convolutions over U, dc - 2 jobs; the end edges' 0 +
bwd[0] and 0 + fwd[dc - 1]; the output.  Tolerance: none: each term is one
add and a maximum is exact, and the signs of zero must agree too.  Inputs
are seeded numpy.  No JAX here: the plain core is held to the JAX package
by tests/test_torch_nb_maxdomain.py.
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
    (64, 4, (4, 4)),      # BDS.576.288.GF.64: chains and excl S = 4
    (256, 4, (1, 1)),     # LDPC_N96_K48_GF256_d1_exp
    (256, 12, (2, 1)),    # LDPC_N576_K480_GF256_exp (excl: two rounds)
    (32, 3, (4, 8)),
])
def test_units_equal_the_plain_maxconv(q, dc, splits):
    """Each phase's units, against ``_maxconv`` on the same operands,
    the identity among them; S for the chains (2 jobs) and for the
    exclusive convolutions (dc - 2 jobs)."""
    nth = 32 * dc
    assert (split(q, nth, 2), split(q, nth, dc - 2)) == splits
    rng = np.random.default_rng(q + dc)
    for njobs in (2, dc - 2):
        A = torch.from_numpy(rng.normal(0, 6, (3, njobs, q)).astype(np.float32))
        B = torch.from_numpy(rng.normal(0, 6, (3, njobs, q)).astype(np.float32))
        A[0, 0] = _identity(q)
        B[1, -1] = _identity(q)
        assert torch.equal(maxconvs(A, B, nth), nb_decode._maxconv(A, B))


@pytest.mark.parametrize("name", ["BDS.576.288.GF.64",
                                  "LDPC_N576_K288_GF64_d1_exp",
                                  "LDPC_N96_K48_GF256_d1_exp"])
def test_row_wiring_equals_the_plain_row(name):
    """ems_full_row: U over X; fwd[1] = 0 + U[0] in Y[1], bwd[dc - 2] = 0 +
    U[dc - 1] in A[dc - 2]; for s = 1 .. dc - 2 one step of each chain a
    phase (fwd in Y, bwd in A); the inner edges' exclusive convolutions
    over X; then c2v[k] = (e[h k] - e[0]) * f32(1/1.2) with e = 0 + the
    edge's exclusive values (A[0] and Y[dc - 1] for the end edges), the
    kernel's index h ? h k : 0 (LDPC_N576_K288_GF64_d1_exp has two
    coefficient-0 edges).  Messages in eighth steps at or below 0, zeros
    of both signs among them, so that the maxima are often a zero and a
    sign the copies got wrong would show in c2v."""
    code = NBCode.from_registry(name)
    g = nb_decode.build_graph(code)
    q, dc, nth = g.q, g.dc, 32 * g.dc
    h_perm = torch.as_tensor(g.h_perm)
    mask = torch.as_tensor(g.cn_mask)
    rng = np.random.default_rng(dc * q)
    v2c = -np.abs(np.round(rng.normal(0, 0.1, (2, g.M, dc, q)) * 8) / 8)
    v2c = np.where(v2c == 0, np.where(rng.random(v2c.shape) < 0.5, 0.0,
                                      -0.0), v2c)
    v2c = torch.from_numpy(v2c.astype(np.float32))
    X = nb_decode._to_cn_domain(v2c, h_perm)             # [B, M, dc, q]
    Y = {1: 0.0 + X[:, :, 0]}                            # fwd
    A = {dc - 2: 0.0 + X[:, :, dc - 1]}                  # bwd
    for s in range(1, dc - 1):
        d = dc - 1 - s
        out = maxconvs(torch.stack([Y[s], A[d]], dim=2),
                       torch.stack([X[:, :, s], X[:, :, d]], dim=2), nth)
        Y[s + 1], A[d - 1] = out[:, :, 0], out[:, :, 1]
    inner = list(range(1, dc - 1))
    excl = maxconvs(torch.stack([Y[d] for d in inner], dim=2),
                    torch.stack([A[d] for d in inner], dim=2), nth)
    E = 0.0 + torch.stack([A[0]] + [excl[:, :, i] for i in range(dc - 2)]
                          + [Y[dc - 1]], dim=2)
    idx = torch.where(h_perm[..., 1:2] != 0, h_perm, 0)
    out = torch.gather(E, -1, idx[None].expand(E.shape))
    c2v = (out - E[..., :1]) * nb_decode.EMS_SCALE
    plain = nb_decode._ems_full_cn_core(v2c, mask, h_perm, dc, q)
    assert bool((h_perm[..., 1] == 0).any()) == (
        name == "LDPC_N576_K288_GF64_d1_exp")
    assert torch.signbit(X).any() and (X == 0).any()
    assert torch.equal(c2v, plain)
    assert torch.equal(torch.signbit(c2v), torch.signbit(plain))
