"""Non-binary GF(q) LDPC decoding, plain PyTorch: the FFT-QSPA family —
flooding, row-layered and grouped-layered exact sum-product (counterpart of
cuda_ldpc_tpu/ops/nb_decode.py:50-186, 393-436, 525-702 and 707-814; the
EMS and TMM cores come with the K8 slice, ROADMAP.md Queue 1 item 12).

This is the reference the CUDA kernels (ops/cuda_qspa.py, K5, and
ops/cuda_qspa_qc.py, K6) are held against on the card, and it is held
against the JAX package's ``nb_decode`` on the CPU: ok and iters exactly,
hard on every frame whose check passed (the QSPA tolerance VALIDATION.md:
94-104 documents for the JAX package's own kernels).  So that a kernel can
equal it bit for bit, every floating-point order is fixed here and the
kernels follow it:

* the GF permutations are index gathers through the multiplication table
  (exact), where the JAX package contracts one-hot matrices;
* permute, then softmax: max, exp(x - max), a sum in pairwise-halving order
  (element i with i + q/2, then again on the first half — ``_rtree`` of
  cuda_ldpc_tpu/ops/pallas_qspa_qc.py:205-212), then a divide;
* the Walsh-Hadamard transform is log2(q) butterfly stages, stride 1 first,
  each ``(a, c) -> (a + c, a - c)``, never a matmul (whose order cuBLAS
  picks, and which TF32 would ruin);
* exclusive products run forward and backward over the row's slots in the
  JAX order; padded slots carry the all-ones spectrum, so a kernel that
  skips them computes the same numbers;
* flooding totals are L + (c2v summed over the VN's slots in slot order);
  layered totals are updated as T + (new - old);
* a frame whose syndrome passes at the entry of pass t reports t iterations
  and is frozen from then on; ``max_iters = 0`` returns zeros.

Tensors: symbol LLRs [B, N, q] float32 (``L[..., 0] = 0``), c2v messages
[B, M, max_dc, q] in the CN's slot order.  The early-stop test reads
``ok.all()`` on the host once per pass.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from cuda_ldpc_torch.models.nb_code import NBCode

NEG = -1e30   # finite -inf stand-in (avoids inf-inf NaNs under masking)
EPS = 1e-30   # pmf floor before the log

METHODS = ("ems", "ems_full", "qspa", "layered_qspa", "glayered_qspa",
           "tmm", "layered_tmm", "glayered_tmm")
QSPA_METHODS = ("qspa", "layered_qspa", "glayered_qspa")


@functools.lru_cache(maxsize=None)
def _hadamard(q: int) -> np.ndarray:
    """Walsh-Hadamard matrix H[a, b] = (-1)^popcount(a & b) (natural order).
    Self-inverse up to 1/q; diagonalizes convolution over the XOR group.
    Valid ONLY for q = 2^m (GF(2^m), where symbol addition IS bitwise XOR,
    myNBLDPC/src/GF.cpp:43).  The decoders apply it as butterflies
    (``_wht``); the matrix states what they compute."""
    if q <= 0 or (q & (q - 1)) != 0:
        raise ValueError(f"Hadamard/QSPA requires q = 2^m, got q={q}")
    anb = np.arange(q)[:, None] & np.arange(q)[None, :]
    par = np.zeros_like(anb)
    v = anb.copy()
    while v.any():
        par ^= v & 1
        v >>= 1
    return np.where(par == 1, -1.0, 1.0).astype(np.float32)


def row_groups(cn_links: np.ndarray, cn_mask: np.ndarray) -> list[np.ndarray]:
    """Partition CN rows into conflict-free groups (no two rows in a group
    share a variable node) by greedy coloring, preserving ascending row order
    inside each group.  Rows in one group can run a layered update
    concurrently without read/write interference; for QC-lifted codes this
    recovers the block rows (the 1152-row Tanner_74_9_Z128_GF16 colors into
    its 9 block rows)."""
    M = cn_links.shape[0]
    vn_rows: dict[int, list[int]] = {}
    row_vns = []
    for m in range(M):
        vns = [int(v) for v, ok in zip(cn_links[m], cn_mask[m]) if ok]
        row_vns.append(vns)
        for v in vns:
            vn_rows.setdefault(v, []).append(m)
    color = np.full(M, -1, dtype=np.int64)
    for m in range(M):
        used = {int(color[r]) for v in row_vns[m] for r in vn_rows[v]
                if color[r] >= 0}
        c = 0
        while c in used:
            c += 1
        color[m] = c
    return [np.flatnonzero(color == c) for c in range(int(color.max()) + 1)]


class NBDecodeResult(NamedTuple):
    hard: torch.Tensor    # [B, N] int32 hard symbol decisions
    ok: torch.Tensor      # [B] bool — GF syndrome == 0
    iters: torch.Tensor   # [B] int32 — iterations used (reference counting)


class _Graph(NamedTuple):
    """Static numpy graph tensors."""
    q: int
    N: int
    M: int
    dv: int
    dc: int
    vn_gather: np.ndarray   # [N, dv] flat index into the [M*dc] CN-edge axis
    vn_mask: np.ndarray     # [N, dv] bool
    cn_links: np.ndarray    # [M, dc] VN index
    cn_mask: np.ndarray     # [M, dc] bool
    h_perm: np.ndarray      # [M, dc, q]: k -> h*k  (all-0 rows on masked edges)
    mul_table: np.ndarray   # [q, q]


def build_graph(code: NBCode) -> _Graph:
    h_perm = code.mul_table[code.cn_gf].astype(np.int64)
    return _Graph(q=code.q, N=code.n_sym, M=code.m_sym, dv=code.max_dv,
                  dc=code.max_dc,
                  vn_gather=code.vn_links * code.max_dc + code.vn_slot,
                  vn_mask=code.vn_mask, cn_links=code.cn_links,
                  cn_mask=code.cn_mask, h_perm=h_perm,
                  mul_table=code.mul_table.astype(np.int64))


# --------------------------------------------------------------------------
# shared phases
# --------------------------------------------------------------------------

def _rtree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by pairwise halving (element i with i + n/2,
    then again on the first half) -> [..., 1]."""
    n = x.shape[-1]
    while n > 1:
        h = n // 2
        x = x[..., :h] + x[..., h:n]
        n = h
    return x


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis: max, exp(x - max), ``_rtree_sum``,
    divide."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / _rtree_sum(e)


def _wht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised Walsh-Hadamard transform over the last axis (q = 2^m):
    butterfly stages of stride 1, 2, ..., q/2, each (a, c) -> (a + c, a - c),
    which equals x @ _hadamard(q) up to rounding."""
    q = x.shape[-1]
    s = 1
    while s < q:
        y = x.reshape(x.shape[:-1] + (q // (2 * s), 2, s))
        a, c = y[..., 0, :], y[..., 1, :]
        x = torch.stack((a + c, a - c), dim=-2).reshape(x.shape[:-1] + (q,))
        s *= 2
    return x


def _gather_c2v_vn(g: _Graph, c2v_cn: torch.Tensor) -> torch.Tensor:
    """CN-aligned c2v [B, M, dc, q] -> VN-aligned [B, N, dv, q] (masked)."""
    B = c2v_cn.shape[0]
    dev = c2v_cn.device
    flat = c2v_cn.reshape(B, g.M * g.dc, g.q)
    out = flat[:, torch.as_tensor(g.vn_gather, device=dev)]
    mask = torch.as_tensor(g.vn_mask, device=dev)[None, :, :, None]
    return torch.where(mask, out, 0.0)


def _syndrome_ok(g: _Graph, hard: torch.Tensor) -> torch.Tensor:
    """True GF syndrome check per frame: all rows have sum h_i * x_i == 0
    (myNBLDPC/src/LDPC_Decoder.cpp:218-238).  hard: [B, N] integer."""
    dev = hard.device
    hard_cn = hard[:, torch.as_tensor(g.cn_links, device=dev)].long()
    h = torch.as_tensor(g.h_perm[:, :, 1], device=dev)   # h*1 = h; pad 0
    mul = torch.as_tensor(g.mul_table, device=dev)
    contrib = mul[h[None], hard_cn]                      # [B, M, dc]
    syn = contrib[:, :, 0]
    for d in range(1, g.dc):
        syn = torch.bitwise_xor(syn, contrib[:, :, d])
    return (syn == 0).all(dim=1)


def _inverse_perm(h_perm: torch.Tensor) -> torch.Tensor:
    """[..., q] permutations k -> h*k -> their inverses v -> h^-1 v (the
    all-0 rows of masked edges map to an arbitrary order; callers mask
    them)."""
    return torch.argsort(h_perm, dim=-1, stable=True)


def _qspa_cn_core(v2c_cn: torch.Tensor, mask: torch.Tensor,
                  h_perm: torch.Tensor, dc: int, q: int,
                  eps: float = EPS) -> torch.Tensor:
    """True probability-domain sum-product (FFT-QSPA) CN update.

    The check constraint sum_d h_d x_d = 0 makes each c2v message the
    XOR-group convolution of the other edges' pmfs of y_d = h_d x_d; the
    Walsh-Hadamard transform diagonalizes that convolution, so the update is
    a transform, an exclusive product across edges and the inverse
    transform.  v2c_cn: [B, M', dc, q] LLR-domain messages over VN symbols
    (L[0] = 0); mask [M', dc] bool; h_perm [M', dc, q] long (k -> h*k).
    Returns c2v in the same domain and shape."""
    B = v2c_cn.shape[0]
    maskq = mask[None, :, :, None]
    full = (B,) + tuple(h_perm.shape)
    # U[y] = v2c[h^-1 y]: the LLRs over y = h*x
    U = torch.gather(v2c_cn, -1, _inverse_perm(h_perm)[None].expand(full))
    # A coefficient 0 (LDPC_N576_K288_GF64_d1_exp has two in its file): the
    # JAX package's one-hot contraction puts the sum of v2c at y = 0 and 0
    # elsewhere, and its output gather makes the edge's c2v 0; so here.
    h_zero = (h_perm[..., 1] == 0)[None, :, :, None]
    y0 = torch.arange(q, device=U.device) == 0
    U = torch.where(h_zero, torch.where(y0, _rtree_sum(v2c_cn), 0.0), U)
    p = _softmax(torch.where(maskq, U, NEG))
    # padded edges carry the delta-at-0 pmf = the convolution identity
    ident = torch.zeros(q, dtype=p.dtype, device=p.device)
    ident[0] = 1.0
    p = torch.where(maskq, p, ident)
    F = _wht(p)
    one = torch.ones_like(F[:, :, 0])
    fwd = [one]
    for d in range(dc - 1):
        fwd.append(fwd[-1] * F[:, :, d])
    bwd = [one]
    for d in range(dc - 1, 0, -1):
        bwd.append(bwd[-1] * F[:, :, d])
    bwd = bwd[::-1]
    excl = torch.stack([fwd[d] * bwd[d] for d in range(dc)], dim=2)
    pout = _wht(excl) / q
    # tiny negatives can appear from float cancellation; clip before the log
    llr = torch.log(torch.clamp_min(pout, eps))
    out = torch.gather(llr, -1, h_perm[None].expand(full))   # out[k] = llr[h*k]
    out = out - out[..., 0:1]
    return torch.where(maskq, out, 0.0)


# --------------------------------------------------------------------------
# decoders
# --------------------------------------------------------------------------

def _freeze(active: torch.Tensor, new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    """Per-frame select along the batch axis (active: [B])."""
    a = active.reshape(active.shape + (1,) * (new.dim() - 1))
    return torch.where(a, new, old)


class DecoderCore(NamedTuple):
    """A decoder decomposed into per-pass pieces for the decode loop (_run)."""
    g: _Graph
    init: Callable    # L_ch [B, N, q] -> carry
    decide: Callable  # carry -> (hard [B, N] int32, llr)
    step: Callable    # (carry, llr, cont [B] bool) -> carry


class _Rows(NamedTuple):
    """Device tensors of a set of CN rows for the layered schedules."""
    rows: torch.Tensor      # [G] row indices
    links: torch.Tensor     # [G, dc] VN indices
    mask: torch.Tensor      # [G, dc] bool
    h_perm: torch.Tensor    # [G, dc, q]
    real: torch.Tensor      # [G*dc] bool: flattened mask
    vns: torch.Tensor       # [sum(mask)] VN of each real edge (distinct)


def _rows(g: _Graph, rows: np.ndarray, dev: torch.device) -> _Rows:
    t = functools.partial(torch.as_tensor, device=dev)
    mask = g.cn_mask[rows]
    return _Rows(t(rows), t(g.cn_links[rows]), t(mask), t(g.h_perm[rows]),
                 t(mask.reshape(-1)), t(g.cn_links[rows][mask]))


def build_core(code: NBCode, method: str,
               device: torch.device | str = "cpu") -> DecoderCore:
    """Decoder core for ``method`` ('qspa' | 'layered_qspa' |
    'glayered_qspa') with its graph tensors on ``device``."""
    if method not in QSPA_METHODS:
        if method in METHODS:
            raise NotImplementedError(
                f"method {method!r} is not ported to cuda_ldpc_torch yet "
                "(ROADMAP.md Queue 1 item 12 and kernel K8, EMS/TMM)")
        raise ValueError(f"unknown NB decoder method {method!r}")
    g = build_graph(code)
    dev = torch.device(device)
    _hadamard(g.q)                      # validates q = 2^m

    def init(L_ch):
        L = L_ch.to(torch.float32)
        c2v0 = torch.zeros((L.shape[0], g.M, g.dc, g.q), dtype=torch.float32,
                           device=L.device)
        return (L, c2v0)

    if method == "qspa":
        cn_links = torch.as_tensor(g.cn_links, device=dev)
        mask = torch.as_tensor(g.cn_mask, device=dev)
        h_perm = torch.as_tensor(g.h_perm, device=dev)

        def decide(carry):
            L, c2v = carry
            gathered = _gather_c2v_vn(g, c2v)
            s = gathered[:, :, 0]
            for d in range(1, g.dv):           # slot order, one add at a time
                s = s + gathered[:, :, d]
            llr = L + s
            # argmax with 0 fallback == plain argmax, since L[0] = 0 exactly
            # (DecideLLRVector, LDPC_Decoder.cpp:71-91)
            return llr.argmax(dim=-1).to(torch.int32), llr

        def step(carry, llr, cont):
            L, c2v = carry
            v2c = llr[:, cn_links] - c2v
            new = _qspa_cn_core(v2c, mask, h_perm, g.dc, g.q)
            return (L, _freeze(cont, new, c2v))

        return DecoderCore(g, init, decide, step)

    # layered: rows one at a time; grouped-layered: greedy-colored
    # conflict-free row groups in sequence, the rows of a group at once
    if method == "layered_qspa":
        parts = [np.array([m]) for m in range(g.M)]
    else:
        parts = row_groups(g.cn_links, g.cn_mask)
    parts = [_rows(g, rows, dev) for rows in parts]

    def decide(carry):
        llr, _ = carry
        return llr.argmax(dim=-1).to(torch.int32), llr

    def step(carry, llr_unused, cont):
        llr0, c2v0 = carry
        llr, c2v = llr0.clone(), c2v0.clone()
        for r in parts:
            old = c2v[:, r.rows]                         # [B, G, dc, q]
            v2c = llr[:, r.links] - old
            new = _qspa_cn_core(v2c, r.mask, r.h_perm, g.dc, g.q)
            # write back total = T + (new - old) on the real edges; a row
            # (and a group) touches each VN at most once
            delta = (new - old).flatten(1, 2)[:, r.real]
            llr[:, r.vns] = llr[:, r.vns] + delta
            c2v[:, r.rows] = new
        return (_freeze(cont, llr, llr0), _freeze(cont, c2v, c2v0))

    return DecoderCore(g, init, decide, step)


def _run(g: _Graph, B: int, max_iters: int, early_stop: bool, carry,
         step_fn, decide_fn, device: torch.device) -> NBDecodeResult:
    """The JAX while loop with the reference's iteration accounting: each
    pass decides from the current state, checks the syndrome, then (for
    frames still active) runs one CN-update phase.  The update after the
    last pass is skipped: no output depends on it."""
    hard = torch.zeros((B, g.N), dtype=torch.int32, device=device)
    ok = torch.zeros(B, dtype=torch.bool, device=device)
    iters = torch.zeros(B, dtype=torch.int32, device=device)
    t = 0
    while t < max_iters and not (early_stop and bool(ok.all())):
        hard_new, llr = decide_fn(carry)
        ok_new = _syndrome_ok(g, hard_new)
        active = ~ok
        hard = _freeze(active, hard_new, hard)
        iters = torch.where(active & ok_new, t,
                            torch.where(active, t + 1, iters)).to(torch.int32)
        cont = active & ~ok_new
        ok = torch.where(active, ok_new, ok)
        t += 1
        if t < max_iters and not (early_stop and bool(ok.all())):
            carry = step_fn(carry, llr, cont)
    return NBDecodeResult(hard, ok, iters)


def decode(L_ch: torch.Tensor, code: NBCode, method: str, max_iters: int,
           early_stop: bool = True) -> NBDecodeResult:
    """Decode [B, N, q] symbol LLRs (log P(s)/P(0), L[..., 0] = 0) with
    ``method`` from QSPA_METHODS."""
    core = build_core(code, method, L_ch.device)
    return _run(core.g, L_ch.shape[0], max_iters, early_stop,
                core.init(L_ch), core.step, core.decide, L_ch.device)


def decode_qspa(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                early_stop: bool = True) -> NBDecodeResult:
    """Flooding FFT-QSPA (exact sum-product via Walsh-Hadamard CN
    convolution)."""
    return decode(L_ch, code, "qspa", max_iters, early_stop)


def decode_layered_qspa(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                        early_stop: bool = True) -> NBDecodeResult:
    """Row-layered FFT-QSPA: serial sweep over CN rows with each row's
    update written back to the LLR totals immediately (the layered schedule
    the reference ships only for TMM, myNBLDPC/src/LDPC_Decoder.cpp:544-702,
    applied to the exact CN rule)."""
    return decode(L_ch, code, "layered_qspa", max_iters, early_stop)


def decode_glayered_qspa(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                         early_stop: bool = True) -> NBDecodeResult:
    """Grouped-layered FFT-QSPA: the ``row_groups`` of the code in sequence,
    the rows of a group updated at once (for a QC code, its block rows)."""
    return decode(L_ch, code, "glayered_qspa", max_iters, early_stop)
