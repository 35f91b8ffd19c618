"""The layouts of K5's check row (cuda_ldpc_torch.ops.cuda_qspa.row_layout),
their launch shapes, and the row-on-one-warp lane mapping of
csrc/qspa.cu's ``warp_row``, on the CPU.

A row on one warp puts edge d in lane group d (W = 32 / dc' lanes, dc' the
largest row degree rounded up to a power of two) and symbol l + W j in the
group's lane l, register j.  A torch emulation of that mapping, with each
shuffle an index gather over the 32 lanes and each register step a slice,
runs the kernel's steps in the kernel's order; its pairwise sum, transform
and whole check-row update must equal nb_decode's ``_rtree_sum``, ``_wht``
and ``_qspa_cn_core`` bit for bit (tolerance: none) on seeded numpy
inputs.  No JAX here: the plain core is held to the JAX package by
tests/test_torch_nb_decode.py.
"""

import re

import numpy as np
import pytest
import torch

from cuda_ldpc_torch import NBCode
from cuda_ldpc_torch.ops import cuda_qspa, nb_decode
from cuda_ldpc_torch.utils import gf as gflib

# code -> the layout the dispatch rule picks, and dc' (the largest row
# degree rounded up to a power of two)
LAYOUTS = {"BDS.576.288.GF.64": ("warp", 4),
           "LDPC_N576_K288_GF64_d1_exp": ("warp", 4),
           "LDPC_N96_K48_GF256_d1_exp": ("groups", 4),
           "LDPC_N576_K480_GF256_exp": ("groups", 16)}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_the_dispatch_rule_picks_the_layout(name):
    """A row on one warp where dc' q <= 256 (8 lanes an edge, 8 symbols a
    lane on GF(64)); a warp an edge on one row group elsewhere (the only
    group count the kernel is built for)."""
    plan = cuda_qspa.make_plan(NBCode.from_registry(name))
    layout, dcp = LAYOUTS[name]
    assert cuda_qspa.padded_degree(plan) == dcp
    assert cuda_qspa.row_layout(plan) == layout
    assert cuda_qspa.warp_fits(plan) == (layout == "warp")
    assert (dcp * plan.q <= 256) == (layout == "warp")
    for layered in (False, True):
        assert cuda_qspa.launch_shape(plan, layered, "groups") == (0, 1)
    with pytest.raises(ValueError, match="design"):
        cuda_qspa.launch_shape(plan, False, "rows")
    if layout == "groups":
        with pytest.raises(ValueError, match="one warp"):
            cuda_qspa.launch_shape(plan, False, "warp")


@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_launch_shapes_fit_a_block(name, layered):
    """Every design's block: a warp an edge on one row group, at most 1024
    threads (the serial design, one row at a time, is gone); a row on one
    warp at least 2 warps (each is a row group of walk_waves) and at most
    the kernel's launch bound for the schedule; shared memory within 227
    KB, and the row-a-warp block without the row scratch, with the frame's
    C for flooding."""
    plan = cuda_qspa.make_plan(NBCode.from_registry(name))
    with pytest.raises(ValueError, match="design"):
        cuda_qspa.launch_shape(plan, layered, "serial")
    layout, G = cuda_qspa.launch_shape(plan, layered, "groups")
    assert (layout, G) == (0, 1)
    assert 32 * plan.max_dc <= 1024
    assert cuda_qspa.smem_bytes(plan, G) <= cuda_qspa.SMEM_LIMIT
    if cuda_qspa.warp_fits(plan):
        layout, nw = cuda_qspa.launch_shape(plan, layered, "warp")
        chip = cuda_qspa.c_on_chip(layered)
        assert chip == (not layered)           # C on chip for flooding only
        assert layout == 1
        assert 2 <= nw <= cuda_qspa.WARP_BOUNDS[layered][0] // 32
        smem = cuda_qspa.smem_bytes(plan, 0, chip)
        assert smem == 4 * (plan.N * plan.q + plan.q + 2 * (plan.q - 1)
                            + plan.N + (plan.E * plan.q if chip else 0))
        assert smem <= cuda_qspa.SMEM_LIMIT
        # BDS: 8 frames an SM by shared memory, 3 with C on chip
        assert cuda_qspa.SM_SMEM // (smem + cuda_qspa.SM_BLOCK_RESERVE) == (
            3 if chip else 8)


def test_warp_bounds_match_the_source():
    """The host's launch bounds of a row on one warp, by schedule, are
    csrc/qspa.cu's kWarpBounds (flooding first)."""
    from cuda_ldpc_torch.ops import _build
    src = (_build.CSRC_DIR / "qspa.cu").read_text()
    got = re.search(r"kWarpBounds\[2\]\[2\] = \{\{(\d+), (\d+)\}, "
                    r"\{(\d+), (\d+)\}\};", src)
    assert got is not None
    n = [int(x) for x in got.groups()]
    assert cuda_qspa.WARP_BOUNDS == {False: tuple(n[:2]), True: tuple(n[2:])}
    for layered in (False, True):
        assert 32 * cuda_qspa.warps(layered) <= (
            cuda_qspa.WARP_BOUNDS[layered][0])


# ---- the lane mapping, emulated

LANE = torch.arange(32)


def to_lanes(x, W):
    """[dc', q] -> [32, RL]: lane t, register j holds edge t // W, symbol
    t % W + W j."""
    RL = x.shape[1] // W
    return x[LANE[:, None] // W, LANE[:, None] % W + W * torch.arange(RL)]


def from_lanes(X, W):
    """The inverse of ``to_lanes``."""
    RL = X.shape[1]
    out = torch.empty((32 // W, W * RL), dtype=X.dtype)
    out[LANE[:, None] // W, LANE[:, None] % W + W * torch.arange(RL)] = X
    return out


def shfl_xor(X, o):
    return X[LANE ^ o]


def group_rtree_sum(X, W):
    """qspa_common.cuh group_rtree_sum: register halving, then shuffles
    down within the group; every lane gets its group's lane 0."""
    n = X.shape[1]
    while n > 1:
        h = n // 2
        X = X[:, :h] + X[:, h:n]
        n = h
    s = X[:, 0]
    o = W // 2
    while o:
        s = s + s[torch.where(LANE % W + o < W, LANE + o, LANE)]
        o //= 2
    return s[LANE - LANE % W][:, None]


def group_max(X, W):
    m = X.amax(dim=1)
    o = W // 2
    while o:
        m = torch.maximum(m, shfl_xor(m, o))
        o //= 2
    return m[:, None]


def group_wht(X, W):
    """qspa_common.cuh group_wht: strides below W pair lanes, the others
    registers."""
    s = 1
    while s < W:
        P = shfl_xor(X, s)
        X = torch.where((LANE & s)[:, None] != 0, P - X, X + P)
        s *= 2
    RL = X.shape[1]
    sr = 1
    while sr < RL:
        Y = X.reshape(32, RL // (2 * sr), 2, sr)
        a, c = Y[:, :, 0], Y[:, :, 1]
        X = torch.stack((a + c, a - c), dim=2).reshape(32, RL)
        sr *= 2
    return X


def warp_row(v2c, h, q, dcp):
    """csrc/qspa.cu warp_row on a row of dc <= dcp edges: v2c [dc, q] VN
    -domain messages, h [dc] coefficients -> the c2v messages [dc, q]."""
    dc = len(h)
    W = 32 // dcp
    exp, log = gflib.exp_log_tables(q)
    d, l = LANE // W, LANE % W
    hl = torch.as_tensor(np.concatenate([h, np.zeros(dcp - dc, int)]))[d]
    y = l[:, None] + W * torch.arange(q // W)
    div = torch.as_tensor(exp[(log[np.maximum(y.numpy(), 1)] - log[
        np.maximum(hl.numpy(), 1)][:, None]) % (q - 1)])
    addr = torch.where((hl[:, None] != 0) & (y != 0), div, y)
    mine = (d < dc)[:, None]
    X = torch.where(mine, v2c[torch.clamp(d, max=dc - 1)[:, None], addr], 0.0)
    zero_h = (hl == 0)[:, None]
    if bool((mine & zero_h).any()):
        s = group_rtree_sum(X, W)
        X = torch.where(zero_h, torch.where(y == 0, s, 0.0), X)
    e = torch.exp(X - group_max(X, W))
    X = e / group_rtree_sum(e, W)
    X = group_wht(X, W)
    f = torch.ones_like(X)
    bw = torch.ones_like(X)
    for i in range(dcp):
        v = X[i * W + l]
        f = torch.where((i < d)[:, None], f * v, f)
    for i in range(dcp - 1, 0, -1):
        v = X[i * W + l]
        bw = torch.where(((i > d) & (i < dc))[:, None], bw * v, bw)
    X = group_wht(f * bw, W)
    X = torch.log(torch.clamp_min(X / q, nb_decode.EPS))
    X = X - X[LANE - LANE % W, :1]
    X = torch.where(zero_h, 0.0, X)
    out = torch.zeros((dcp, q), dtype=torch.float32)
    out[d[:, None].expand(-1, q // W), addr] = X
    return out[:dc]


# (q, row degree): BDS's shape and a row of 3 edges (an idle lane group),
# which the kernel is built for, and lane groups of 4 lanes (dc' = 8) and
# of 8 lanes with 4 symbols a lane (q = 32), where the steps must pair the
# same symbols in the same order too
ROWS = [(64, 4), (64, 3), (32, 8), (32, 6), (32, 4)]


def _row(q, dc, seed, zero_h=False):
    rng = np.random.default_rng(seed)
    v2c = rng.normal(0.0, 3.0, (dc, q)).astype(np.float32)
    v2c[:, 0] = 0.0
    h = rng.integers(1, q, dc)
    if zero_h:
        h[1] = 0
    return torch.from_numpy(v2c), h


@pytest.mark.parametrize("q,dc", ROWS)
def test_lane_sum_and_transform_equal_the_plain_ones(q, dc):
    dcp = 1 << (dc - 1).bit_length()
    W = 32 // dcp
    x = torch.from_numpy(np.random.default_rng(q + dc).normal(
        0.0, 1.0, (dcp, q)).astype(np.float32))
    X = to_lanes(x, W)
    assert torch.equal(from_lanes(X, W), x)
    assert torch.equal(group_rtree_sum(X, W)[::W, 0],
                       nb_decode._rtree_sum(x)[:, 0])
    assert torch.equal(from_lanes(group_wht(X, W), W), nb_decode._wht(x))


@pytest.mark.parametrize("zero_h", [False, True])
@pytest.mark.parametrize("q,dc", ROWS)
def test_warp_row_equals_the_plain_row(q, dc, zero_h):
    """The whole row update, exclusive products in the JAX order included,
    equals ``_qspa_cn_core`` on the same row, bit for bit; a coefficient 0
    (LDPC_N576_K288_GF64_d1_exp has two) too."""
    dcp = 1 << (dc - 1).bit_length()
    v2c, h = _row(q, dc, 7 * q + dc, zero_h)
    mul = gflib.mul_table(q)
    h_perm = torch.as_tensor(mul[h][None], dtype=torch.long)  # [1, dc, q]
    want = nb_decode._qspa_cn_core(v2c[None, None],
                                   torch.ones((1, dc), dtype=torch.bool),
                                   h_perm, dc, q)[0, 0]
    got = warp_row(v2c, h, q, dcp)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
