"""Non-binary GF(q) LDPC decoding, plain PyTorch: the FFT-QSPA family
(flooding, row-layered and grouped-layered exact sum-product) and the
max-domain family (EMS, full EMS, TMM, layered and grouped-layered TMM),
the counterpart of cuda_ldpc_tpu/ops/nb_decode.py.

This is the reference the CUDA kernels (ops/cuda_qspa.py, K5;
ops/cuda_qspa_qc.py, K6; ops/cuda_nbms.py, K8) are held against on the
card, and it is held against the JAX package's ``nb_decode`` on the CPU:
the max-domain decoders give hard, ok and iters exactly; the QSPA decoders
ok and iters exactly and hard on every frame whose check passed (the QSPA
tolerance VALIDATION.md:94-104 documents for the JAX package's own
kernels).  So that a kernel can equal it bit for bit, every floating-point
order is fixed here and the kernels follow it:

* the GF permutations are index gathers through the multiplication table
  (exact), where the JAX package contracts one-hot matrices; an edge with
  coefficient 0 gets what that contraction gives it: the sum of its v2c
  (``_rtree_sum``) at y = 0 and 0 elsewhere on the way in, and out[k] =
  x[0] for every k on the way out;
* XOR shifts x[y] -> x[y ^ s] are index gathers (exact);
* permute, then softmax: max, exp(x - max), a sum in pairwise-halving order
  (element i with i + q/2, then again on the first half — ``_rtree`` of
  cuda_ldpc_tpu/ops/pallas_qspa_qc.py:205-212), then a divide;
* the Walsh-Hadamard transform is log2(q) butterfly stages, stride 1 first,
  each ``(a, c) -> (a + c, a - c)``, never a matmul (whose order cuBLAS
  picks, and which TF32 would ruin);
* exclusive products run forward and backward over the row's slots in the
  JAX order; padded slots carry the all-ones spectrum, so a kernel that
  skips them computes the same numbers;
* max, min, argmax and argmin are exact; every argmax and argmin keeps the
  first index on ties, and the top-(Nm-1) selection of EMS takes equal
  values in index order (``jax.lax.top_k``'s rule, not ``torch.topk``'s);
* the EMS output is (D[h*k ^ g0] - D[g0]) * f32(1/1.2) and the TMM output
  f32(0.8) * Lc2p[h*k ^ beta]: multiplies, never divides;
* flooding totals are L + (c2v summed over the VN's slots in slot order);
  flooding TMM keeps the reference's accumulating state, T + (that sum)
  (myNBLDPC/src/LDPC_Decoder.cpp:425-435); layered QSPA updates the totals
  as T + (new - old), layered TMM as T + ((v2c + new) - T), the JAX order
  (nb_decode.py:686-691), where the TPU kernel writes v2c + new directly.
  There v2c + new, with new = 0.8 x, is one fused multiply-add rounded
  once (``_fma_f32``): XLA contracts it so on the CPU, and without it a
  fifth of the totals differ from the JAX package's in the last bit after
  one pass;
* a frame whose syndrome passes at the entry of pass t reports t iterations
  and is frozen from then on; ``max_iters = 0`` returns zeros.

Tensors: symbol LLRs [B, N, q] float32 (``L[..., 0] = 0``; the TMM methods
convert to the min domain, ``to_min_domain``), c2v messages [B, M, max_dc,
q] in the CN's slot order.  The early-stop test reads ``ok.all()`` on the
host once per pass.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from cuda_ldpc_torch.models.nb_code import NBCode

NEG = -1e30   # finite -inf stand-in (avoids inf-inf NaNs under masking)
POS = 1e30
EPS = 1e-30   # pmf floor before the log
# The JAX package's output scalings as the float32 values it multiplies by
# (a Python float meets a float32 array there, so it rounds them first).
EMS_SCALE = float(np.float32(1.0 / 1.2))
TMM_SCALE = float(np.float32(0.8))

METHODS = ("ems", "ems_full", "qspa", "layered_qspa", "glayered_qspa",
           "tmm", "layered_tmm", "glayered_tmm")
QSPA_METHODS = ("qspa", "layered_qspa", "glayered_qspa")
TMM_METHODS = ("tmm", "layered_tmm", "glayered_tmm")


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


def _to_cn_domain(v2c_cn: torch.Tensor, h_perm: torch.Tensor) -> torch.Tensor:
    """U[y] = v2c[h^-1 y], the messages over y = h*x ([B, M', dc, q]; h_perm
    [M', dc, q]).  A coefficient 0 (LDPC_N576_K288_GF64_d1_exp has two in
    its file): the JAX package's one-hot contraction puts the sum of v2c at
    y = 0 and 0 elsewhere; so here."""
    full = (v2c_cn.shape[0],) + tuple(h_perm.shape)
    U = torch.gather(v2c_cn, -1, _inverse_perm(h_perm)[None].expand(full))
    h_zero = (h_perm[..., 1] == 0)[None, :, :, None]
    y0 = torch.arange(h_perm.shape[-1], device=U.device) == 0
    return torch.where(h_zero, torch.where(y0, _rtree_sum(v2c_cn), 0.0), U)


def _to_vn_domain(x: torch.Tensor, h_perm: torch.Tensor) -> torch.Tensor:
    """out[k] = x[h*k] (for a coefficient 0, x[0] for every k, as the JAX
    package's one-hot contraction gives)."""
    full = (x.shape[0],) + tuple(h_perm.shape)
    return torch.gather(x, -1, h_perm[None].expand(full))


def _xor_shift(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x[..., y] -> x[..., y ^ s] along the last axis (GF addition is XOR);
    s has x's shape without the last axis.  An index gather: exact."""
    q = x.shape[-1]
    idx = torch.bitwise_xor(torch.arange(q, device=x.device),
                            s.long()[..., None])
    return torch.gather(x, -1, idx)


def _xor_shift_const(x: torch.Tensor, j: int) -> torch.Tensor:
    """x[..., y] -> x[..., y ^ j] for a constant j."""
    q = x.shape[-1]
    return x[..., torch.bitwise_xor(torch.arange(q, device=x.device), j)]


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
    maskq = mask[None, :, :, None]
    U = _to_cn_domain(v2c_cn, h_perm)
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
    out = _to_vn_domain(llr, h_perm)                # out[k] = llr[h*k]
    out = out - out[..., 0:1]
    return torch.where(maskq, out, 0.0)


# --------------------------------------------------------------------------
# max-domain check-node cores (EMS, full EMS, TMM)
# --------------------------------------------------------------------------

def _top_first(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis,
    largest first, equal values in index order (``jax.lax.top_k``'s rule):
    k first-index argmaxes, each over the entries not taken yet."""
    taken = torch.zeros_like(x, dtype=torch.bool)
    vals, idxs = [], []
    for _ in range(k):
        i = torch.where(taken, float("-inf"), x).argmax(dim=-1, keepdim=True)
        vals.append(torch.gather(x, -1, i))
        idxs.append(i)
        taken = taken.scatter(-1, i, True)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def _maxconv(A: torch.Tensor, Bm: torch.Tensor) -> torch.Tensor:
    """(max,+) convolution over the XOR group: out[x] = max_u A[u] + B[u^x]
    (each term one add, the max exact: any order gives these bits)."""
    q = A.shape[-1]
    ar = torch.arange(q, device=A.device)
    Bg = Bm[..., torch.bitwise_xor(ar[:, None], ar[None, :])]  # [.., u, x]
    return (A[..., :, None] + Bg).amax(dim=-2)


def _ems_cn_core(v2c_cn: torch.Tensor, mask: torch.Tensor,
                 h_perm: torch.Tensor, nm: int, nc: int, dc: int,
                 q: int) -> torch.Tensor:
    """One EMS CN update in the delta domain (the JAX package's
    ``_ems_cn_core``, whose docstring derives it from the reference's
    ConstructConf, myNBLDPC/src/LDPC_Decoder.cpp:272-359).  v2c_cn: [B, M',
    dc, q] VN-symbol-domain messages (L[0] = 0); mask [M', dc]; h_perm
    [M', dc, q].  Returns c2v in the same domain and shape, scaled by
    f32(1/1.2).

    conf(q,1) is the best single deviation of the other edges at each
    offset (max1/max2 across edges with the exclude-own-edge argmax trick);
    conf(Nm,2) adds every pair of other edges at their top-(Nm-1) non-best
    offsets; conf(Nm,Nc>2) is a (max,+) forward/backward DP over the XOR
    group, budgeted by deviation count, or unbudgeted for Nc >= dc-1
    (``check_ems`` states what ``build_core`` refuses)."""
    maskq = mask[None, :, :, None]
    U = torch.where(maskq, _to_cn_domain(v2c_cn, h_perm), NEG)
    c0 = U.argmax(dim=-1)                                 # [B, M', dc]
    v0 = U.amax(dim=-1)
    W = torch.where(maskq, _xor_shift(U, c0) - v0[..., None], NEG)

    # conf(q,1): best / second-best single deviation across edges
    m1 = W.amax(dim=2)                                    # [B, M', q]
    am = W.argmax(dim=2)
    slots = torch.arange(dc, device=W.device)[None, None, :, None]
    m2 = torch.where(am[:, :, None, :] == slots, NEG, W).amax(dim=2)
    D = torch.where(am[:, :, None, :] == slots, m2[:, :, None, :],
                    m1[:, :, None, :])                    # [B, M', dout, q]

    if nc >= 2 and nm >= 2 and dc >= 3:
        yy = torch.arange(q, device=W.device)
        W0 = torch.where(yy == 0, NEG, W)                 # no 0 offset
        P, O = _top_first(W0, nm - 1)                     # [B, M', dc, nm-1]
        if nc == 2:
            # conf(Nm, 2): every pair of edges at their top-(Nm-1) slots
            for a in range(dc):
                for b in range(a + 1, dc):
                    sel = torch.tensor([d != a and d != b for d in range(dc)],
                                       device=W.device)[None, None, :, None]
                    for ka in range(nm - 1):
                        for kb in range(nm - 1):
                            val = P[:, :, a, ka] + P[:, :, b, kb]
                            off = torch.bitwise_xor(O[:, :, a, ka],
                                                    O[:, :, b, kb])
                            upd = torch.where(off[..., None] == yy,
                                              val[..., None], NEG)[:, :, None]
                            D = torch.where(sel, torch.maximum(D, upd), D)
        else:
            # conf(Nm, Nc > 2): per-edge clipped deltas (top-(Nm-1) at their
            # offsets, NEG elsewhere) through exclusive (max,+) chains
            dev = torch.full_like(W, NEG)
            for k in range(nm - 1):
                dev = torch.maximum(dev, torch.where(
                    O[..., k, None] == yy, P[..., k, None], NEG))
            ident = torch.where(yy == 0, 0.0, NEG)
            ident_b = ident.expand(dev[:, :, 0].shape)
            if nc >= dc - 1:
                # unbudgeted: every edge freely deviates or not
                msg = torch.where(maskq, torch.maximum(dev, ident), ident)
                fwd = [ident_b]
                for d in range(dc - 1):
                    fwd.append(_maxconv(fwd[-1], msg[:, :, d]))
                bwd = [ident_b]
                for d in range(dc - 1, 0, -1):
                    bwd.append(_maxconv(bwd[-1], msg[:, :, d]))
                bwd = bwd[::-1]
                D2 = torch.stack([_maxconv(fwd[d], bwd[d])
                                  for d in range(dc)], dim=2)
            else:
                # state[c] = best value with AT MOST c deviations:
                #   F_d[c] = max(F_{d-1}[c], maxconv(F_{d-1}[c-1], dev_d))
                devm = torch.where(maskq, dev, NEG)

                def extend(states, d):
                    return [states[0]] + [
                        torch.maximum(states[c], _maxconv(states[c - 1],
                                                          devm[:, :, d]))
                        for c in range(1, nc + 1)]

                fwd = [[ident_b] * (nc + 1)]
                for d in range(dc - 1):
                    fwd.append(extend(fwd[-1], d))
                bwd = [[ident_b] * (nc + 1)]
                for d in range(dc - 1, 0, -1):
                    bwd.append(extend(bwd[-1], d))
                bwd = bwd[::-1]
                D2 = []
                for d in range(dc):
                    best = _maxconv(fwd[d][0], bwd[d][nc])
                    for c in range(1, nc + 1):
                        best = torch.maximum(best, _maxconv(fwd[d][c],
                                                            bwd[d][nc - c]))
                    D2.append(best)
                D2 = torch.stack(D2, dim=2)
            D = torch.maximum(D, D2)

    # baseline GF value excluding the output edge: g0 = (xor of all c0) ^ c0
    c0m = torch.where(mask[None], c0, 0)
    call = c0m[:, :, 0]
    for d in range(1, dc):
        call = torch.bitwise_xor(call, c0m[:, :, d])
    g0 = torch.bitwise_xor(call[:, :, None], c0m)          # [B, M', dc]
    D_shift = _xor_shift(D, g0)                           # D[y ^ g0]
    Dg = _to_vn_domain(D_shift, h_perm)                   # D[h*k ^ g0]
    c2v = (Dg - D_shift[..., 0:1]) * EMS_SCALE
    return torch.where(maskq, c2v, 0.0)


def _ems_full_cn_core(v2c_cn: torch.Tensor, mask: torch.Tensor,
                      h_perm: torch.Tensor, dc: int, q: int) -> torch.Tensor:
    """Full-configuration EMS (the reference's decoder_method=2: Nm=q,
    Nc=dc-1, Simulation.cpp:64) as exclusive forward/backward (max,+)
    convolutions over the XOR group."""
    maskq = mask[None, :, :, None]
    ident = torch.where(torch.arange(q, device=v2c_cn.device) == 0, 0.0, NEG)
    U = torch.where(maskq, _to_cn_domain(v2c_cn, h_perm), ident)
    fwd = [ident.expand(U[:, :, 0].shape)]
    for d in range(dc - 1):
        fwd.append(_maxconv(fwd[-1], U[:, :, d]))
    bwd = [ident.expand(U[:, :, 0].shape)]
    for d in range(dc - 1, 0, -1):
        bwd.append(_maxconv(bwd[-1], U[:, :, d]))
    bwd = bwd[::-1]
    excl = torch.stack([_maxconv(fwd[d], bwd[d]) for d in range(dc)], dim=2)
    Eg = _to_vn_domain(excl, h_perm)
    c2v = (Eg - excl[..., 0:1]) * EMS_SCALE
    return torch.where(maskq, c2v, 0.0)


def _tmm_cn_core(v2c_cn: torch.Tensor, mask: torch.Tensor,
                 h_perm: torch.Tensor, dc: int, q: int,
                 scaled: bool = True) -> torch.Tensor:
    """One TMM CN update on min-domain messages [B, M', dc, q] (VN symbol
    domain): the reference's d_TMM_Get_Zn / Get_deltaU / Get_Min /
    ConstructConf and the I/E path-select output with the x0.8 damping
    (myNBLDPC/src/LDPC_Decoder.cpp:488-521, 704-817), as the JAX package's
    ``_tmm_cn_core`` computes them.  ``scaled=False`` returns the output
    before the damping (the layered write-back fuses it, ``_fma_f32``)."""
    maskq = mask[None, :, :, None]
    v2c = torch.where(maskq, v2c_cn, POS)
    # Zn: per-edge first argmin over VN symbols, mapped through h
    qmin = v2c.argmin(dim=-1)                             # [B, M', dc]
    vmin = v2c.amin(dim=-1)
    Zn = torch.gather(h_perm[None].expand(v2c.shape), -1,
                      qmin[..., None])[..., 0]
    Zn = torch.where(mask[None], Zn, 0)
    syn = Zn[:, :, 0]
    for d in range(1, dc):
        syn = torch.bitwise_xor(syn, Zn[:, :, d])          # [B, M']

    # delta domain: dU[d][eta] = U[eta ^ Zn[d]] - min
    U = torch.where(maskq, _to_cn_domain(v2c_cn, h_perm), POS)
    dU = torch.where(maskq, _xor_shift(U, Zn) - vmin[..., None], POS)

    # per-eta min1 / min2 and the min1 column across edges
    min1 = dU.amin(dim=2)                                 # [B, M', q]
    col = dU.argmin(dim=2)
    slots = torch.arange(dc, device=dU.device)[None, None, :, None]
    min2 = torch.where(col[:, :, None, :] == slots, POS, dU).amin(dim=2)

    # 2-deviation search: cand = max(min1[j], min1[i^j]) where the two
    # columns and the two values differ; the strict `cand < I2` keeps the
    # first minimizing j
    lane = torch.arange(q, device=dU.device)
    I2 = torch.full_like(min1, POS)
    p1_2 = torch.zeros_like(col)
    p2_2 = torch.zeros_like(col)
    for j in range(q):
        vj = min1[..., j:j + 1]
        cjv = col[..., j:j + 1]
        mk = _xor_shift_const(min1, j)                    # min1[i ^ j]
        ckv = _xor_shift_const(col, j)
        valid = (cjv != ckv) & (vj != mk) & (lane != j)
        cand = torch.where(valid, torch.maximum(vj, mk), POS)
        better = cand < I2
        I2 = torch.where(better, cand, I2)
        p1_2 = torch.where(better, cjv, p1_2)
        p2_2 = torch.where(better, ckv, p2_2)

    use2 = I2 < min1
    I = torch.where(use2, I2, min1)
    E = torch.where(use2, min1, min2)
    p1 = torch.where(use2, p1_2, col)
    p2 = torch.where(use2, p2_2, col)

    # Lc2p[eta] = E on the output edge's path, else I; eta = 0 gets 0;
    # c2v[v] = 0.8 * Lc2p[h*v ^ syn ^ Zn[dout]]
    on_path = (slots == p1[:, :, None, :]) | (slots == p2[:, :, None, :])
    Lc2p = torch.where(on_path, E[:, :, None, :], I[:, :, None, :])
    Lc2p = torch.where(lane == 0, 0.0, Lc2p)              # [B, M', dc, q]
    beta = torch.bitwise_xor(syn[:, :, None], Zn)
    x = torch.where(maskq, _to_vn_domain(_xor_shift(Lc2p, beta), h_perm), 0.0)
    return TMM_SCALE * x if scaled else x


def _fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add does.
    The float64 product is exact; the float64 sum is rounded to odd (an
    inexact sum with an even last bit moves one unit toward the exact
    value, found by TwoSum), which makes the final rounding to float32
    the single correct one."""
    p = a.double() * b
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)               # exact: p + c - s
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def to_min_domain(L_ch: torch.Tensor) -> torch.Tensor:
    """Positive-LLR domain -> TMM min domain: m - L with m the max over the
    nonzero symbols only (Decoding_TMM's init, LDPC_Decoder.cpp:364-390;
    symbol 0 gets m, possibly negative, as in the reference)."""
    return L_ch[..., 1:].amax(dim=-1, keepdim=True) - L_ch


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


def _slot_sum(g: _Graph, c2v_cn: torch.Tensor) -> torch.Tensor:
    """Each VN's c2v summed over its slots in slot order, one add at a
    time -> [B, N, q]."""
    gathered = _gather_c2v_vn(g, c2v_cn)
    s = gathered[:, :, 0]
    for d in range(1, g.dv):
        s = s + gathered[:, :, d]
    return s


def check_ems(nm: int, nc: int, q: int, dc: int) -> None:
    """Raise ValueError for an EMS configuration the JAX package refuses:
    Nc < 1, and Nm - 1 > q where ``_ems_cn_core`` takes each edge's top
    Nm - 1 offsets (Nc >= 2, Nm >= 2, dc >= 3: ``jax.lax.top_k`` takes no
    k beyond its axis, cuda_ldpc_tpu/ops/nb_decode.py:261-268), where
    ``_top_first`` would repeat an offset."""
    if nc < 1:
        raise ValueError(f"EMS needs Nc >= 1, got Nc={nc}")
    if nc >= 2 and nm >= 2 and dc >= 3 and nm - 1 > q:
        raise ValueError(f"EMS needs Nm - 1 <= q = {q} (the top Nm - 1 "
                         f"offsets of an edge), got Nm={nm}")


def build_core(code: NBCode, method: str, device: torch.device | str = "cpu",
               nm: int = 2, nc: int = 2) -> DecoderCore:
    """Decoder core for ``method`` (one of METHODS) with its graph tensors
    on ``device``; ``nm``/``nc`` are EMS's configuration-set sizes."""
    if method not in METHODS:
        raise ValueError(f"unknown NB decoder method {method!r}")
    if method == "ems":
        check_ems(nm, nc, code.q, code.max_dc)
    g = build_graph(code)
    dev = torch.device(device)
    tmm = method in TMM_METHODS
    if method in QSPA_METHODS:
        _hadamard(g.q)                  # validates q = 2^m
    pick = torch.argmin if tmm else torch.argmax

    def cn_core(v2c, mask, h_perm):
        if method == "ems":
            return _ems_cn_core(v2c, mask, h_perm, nm, nc, g.dc, g.q)
        if method == "ems_full":
            return _ems_full_cn_core(v2c, mask, h_perm, g.dc, g.q)
        if tmm:
            return _tmm_cn_core(v2c, mask, h_perm, g.dc, g.q, scaled=False)
        return _qspa_cn_core(v2c, mask, h_perm, g.dc, g.q)

    def init(L_ch):
        L = L_ch.to(torch.float32)
        c2v0 = torch.zeros((L.shape[0], g.M, g.dc, g.q), dtype=torch.float32,
                           device=L.device)
        return (to_min_domain(L) if tmm else L, c2v0)

    if method in ("ems", "ems_full", "qspa", "tmm"):
        cn_links = torch.as_tensor(g.cn_links, device=dev)
        mask = torch.as_tensor(g.cn_mask, device=dev)
        h_perm = torch.as_tensor(g.h_perm, device=dev)

        def decide(carry):
            # EMS/QSPA: L + sum c2v, argmax (with 0 fallback == plain argmax,
            # since L[0] = 0 exactly; DecideLLRVector, LDPC_Decoder.cpp:
            # 71-91).  TMM: the accumulating state + sum c2v, first argmin.
            base, c2v = carry
            llr = base + _slot_sum(g, c2v)
            return pick(llr, dim=-1).to(torch.int32), llr

        def step(carry, llr, cont):
            base, c2v = carry
            new = cn_core(llr[:, cn_links] - c2v, mask, h_perm)
            if tmm:
                new = TMM_SCALE * new
            # flooding TMM keeps the totals as its state for the next pass
            # (LDPC_Decoder.cpp:425-435); EMS and QSPA restart from L
            return (_freeze(cont, llr, base) if tmm else base,
                    _freeze(cont, new, c2v))

        return DecoderCore(g, init, decide, step)

    # layered: rows one at a time; grouped-layered: greedy-colored
    # conflict-free row groups in sequence, the rows of a group at once
    if method in ("layered_qspa", "layered_tmm"):
        parts = [np.array([m]) for m in range(g.M)]
    else:
        parts = row_groups(g.cn_links, g.cn_mask)
    parts = [_rows(g, rows, dev) for rows in parts]

    def decide(carry):
        llr, _ = carry
        return pick(llr, dim=-1).to(torch.int32), llr

    def step(carry, llr_unused, cont):
        llr0, c2v0 = carry
        llr, c2v = llr0.clone(), c2v0.clone()
        for r in parts:
            old = c2v[:, r.rows]                         # [B, G, dc, q]
            llr_rows = llr[:, r.links]
            v2c = llr_rows - old
            new = cn_core(v2c, r.mask, r.h_perm)
            # write back on the real edges (a row, and a group, touches each
            # VN at most once): QSPA total = T + (new - old); TMM total =
            # T + ((v2c + 0.8 x) - T) with v2c + 0.8 x one fused
            # multiply-add, as XLA compiles the JAX function on the CPU
            if tmm:
                delta = _fma_f32(new, TMM_SCALE, v2c) - llr_rows
                new = TMM_SCALE * new
            else:
                delta = new - old
            delta = delta.flatten(1, 2)[:, r.real]
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
           nm: int = 2, nc: int = 2,
           early_stop: bool = True) -> NBDecodeResult:
    """Decode [B, N, q] symbol LLRs (log P(s)/P(0), L[..., 0] = 0) with any
    method of METHODS (the TMM methods convert to the min domain)."""
    core = build_core(code, method, L_ch.device, nm=nm, nc=nc)
    return _run(core.g, L_ch.shape[0], max_iters, early_stop,
                core.init(L_ch), core.step, core.decide, L_ch.device)


def make_decoder(code: NBCode, method: str = "ems", max_iters: int = 20,
                 nm: int = 2, nc: int = 2, early_stop: bool = True):
    """``decode(L_ch) -> NBDecodeResult`` for a code.  ``method``: 'ems' |
    'ems_full' | 'tmm' | 'layered_tmm' — the reference's decoder_method
    0 | 2 | 1 | 3 (myNBLDPC/include/define.h:37, Simulation.cpp:56-69) — or
    'qspa' / 'layered_qspa' / 'glayered_qspa' / 'glayered_tmm'."""
    return functools.partial(decode, code=code, method=method,
                             max_iters=max_iters, nm=nm, nc=nc,
                             early_stop=early_stop)


def decode_ems(L_ch: torch.Tensor, code: NBCode, max_iters: int, nm: int = 2,
               nc: int = 2, full: bool = False,
               early_stop: bool = True) -> NBDecodeResult:
    """Flooding EMS with configuration sets conf(q,1) + conf(Nm,Nc) and the
    /1.2 output scaling (Decoding_EMS, LDPC_Decoder.cpp:172-317);
    ``full=True`` is the reference's decoder_method=2 (Nm=q, Nc=dc-1)."""
    return decode(L_ch, code, "ems_full" if full else "ems", max_iters,
                  nm=nm, nc=nc, early_stop=early_stop)


def decode_tmm(L_ch: torch.Tensor, code: NBCode, max_iters: int,
               early_stop: bool = True) -> NBDecodeResult:
    """Flooding Trellis Min-Max with the x0.8 damping and the reference's
    accumulating LLR totals (Decoding_TMM, LDPC_Decoder.cpp:361-542)."""
    return decode(L_ch, code, "tmm", max_iters, early_stop=early_stop)


def decode_layered_tmm(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                       early_stop: bool = True) -> NBDecodeResult:
    """Row-layered TMM: serial sweep over CN rows, each row's update
    written back to the totals at once (Decoding_layered_TMM,
    LDPC_Decoder.cpp:544-702)."""
    return decode(L_ch, code, "layered_tmm", max_iters,
                  early_stop=early_stop)


def decode_qspa(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                early_stop: bool = True) -> NBDecodeResult:
    """Flooding FFT-QSPA (exact sum-product via Walsh-Hadamard CN
    convolution)."""
    return decode(L_ch, code, "qspa", max_iters, early_stop=early_stop)


def decode_layered_qspa(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                        early_stop: bool = True) -> NBDecodeResult:
    """Row-layered FFT-QSPA: serial sweep over CN rows with each row's
    update written back to the LLR totals immediately (the layered schedule
    the reference ships only for TMM, myNBLDPC/src/LDPC_Decoder.cpp:544-702,
    applied to the exact CN rule)."""
    return decode(L_ch, code, "layered_qspa", max_iters,
                  early_stop=early_stop)


def decode_glayered_qspa(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                         early_stop: bool = True) -> NBDecodeResult:
    """Grouped-layered FFT-QSPA: the ``row_groups`` of the code in sequence,
    the rows of a group updated at once (for a QC code, its block rows)."""
    return decode(L_ch, code, "glayered_qspa", max_iters,
                  early_stop=early_stop)
