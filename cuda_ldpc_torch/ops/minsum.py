"""Binary flooding min-sum on the lifted circulant structure, plain PyTorch
(counterpart of cuda_ldpc_tpu/ops/minsum.py:33-194).

This is the reference the CUDA kernel (ops/cuda_minsum.py) is held against on
the card, and it is held bit-exactly against the JAX package on the CPU.  Its
arithmetic therefore follows the JAX function operation by operation:

* VN totals add the channel value and then each c2v message one at a time
  in ``code.col_edges[l]`` order (a reassociating ``torch.sum`` would change
  the last bits);
* signs are taken with ``q < 0``; the CN writes min2 on the FIRST minimum
  edge (``argmin`` tie rule) and min1 elsewhere; beta is applied before
  alpha;
* ``hard``/``ok`` come from the last VN phase, ``iters`` counts the
  iterations the whole batch ran (batch-global early stop).

Messages are ``[B, E, Z]``; the circulant is ``torch.roll`` along Z.  The
early-stop test reads ``ok.all()`` on the host once per iteration, which
synchronises with the device: fine for a reference, and the reason the
kernel keeps its stop flag on the device instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode

CHECKS = ("zero", "syndrome", "none")


class DecodeResult(NamedTuple):
    hard: torch.Tensor    # [B, L, Z] int8 hard decisions
    ok: torch.Tensor      # [B] bool — early-termination check passed
    iters: torch.Tensor   # 0-d int32 — iterations executed (batch-global)


def _row_stack(code: QCBinaryCode, Q: torch.Tensor, j: int) -> torch.Tensor:
    """Column-aligned edge messages of block-row j -> row-aligned [B, dc, Z]."""
    edges = code.edges
    return torch.stack([torch.roll(Q[:, e], -int(edges[e, 2]), dims=-1)
                        for e in code.row_edges[j]], dim=1)


def _cn_minsum(Qr: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """Two-min + sign-product CN update on row-aligned messages [B, dc, Z]."""
    dc = Qr.shape[1]
    sgn = torch.where(Qr < 0, -1.0, 1.0).to(Qr.dtype)
    mag = Qr.abs()
    sign_prod = torch.prod(sgn, dim=1, keepdim=True)
    min1 = mag.amin(dim=1, keepdim=True)
    amin = mag.argmin(dim=1)                  # first minimum on ties
    is_min = torch.nn.functional.one_hot(amin, dc).movedim(-1, 1).bool()
    big = torch.tensor(torch.finfo(Qr.dtype).max, dtype=Qr.dtype,
                       device=Qr.device)
    min2 = torch.where(is_min, big, mag).amin(dim=1, keepdim=True)
    out = torch.where(is_min, min2, min1)
    if beta:
        out = torch.clamp_min(
            out - torch.tensor(beta, dtype=Qr.dtype, device=Qr.device), 0)
    if alpha != 1.0:
        out = out * torch.tensor(alpha, dtype=Qr.dtype, device=Qr.device)
    return sign_prod * sgn * out


def _vn_update(code: QCBinaryCode, chan: torch.Tensor, R: torch.Tensor):
    """VN phase: totals per column, hard decisions, v2c messages
    (column-aligned)."""
    totals = []
    for l in range(code.L):
        t = chan[:, l]
        for e in code.col_edges[l]:
            t = t + R[:, e]
        totals.append(t)
    total = torch.stack(totals, dim=1)                     # [B, L, Z]
    hard = total < 0
    edge_l = torch.as_tensor(code.edges[:, 1], device=chan.device)
    Q = total[:, edge_l, :] - R                            # v2c, column-aligned
    return total, hard, Q


def _cn_update(code: QCBinaryCode, Q: torch.Tensor, alpha: float,
               beta: float) -> torch.Tensor:
    """CN phase for every block row: new c2v messages [B, E, Z]."""
    newR = [None] * code.num_edges
    for j in range(code.J):
        Rr = _cn_minsum(_row_stack(code, Q, j), alpha, beta)
        for i, e in enumerate(code.row_edges[j]):
            newR[e] = torch.roll(Rr[:, i], int(code.edges[e, 2]), dims=-1)
    return torch.stack(newR, dim=1)


def syndrome_ok(code: QCBinaryCode, hard: torch.Tensor) -> torch.Tensor:
    """True parity check per frame: all CN parities zero. hard: [B, L, Z]
    bool."""
    ok = torch.ones(hard.shape[0], dtype=torch.bool, device=hard.device)
    for j in range(code.J):
        par = None
        for e in code.row_edges[j]:
            l, s = int(code.edges[e, 1]), int(code.edges[e, 2])
            contrib = torch.roll(hard[:, l], -s, dims=-1)
            par = contrib if par is None else par ^ contrib
        ok = ok & ~par.any(dim=-1)
    return ok


def zero_ok(code: QCBinaryCode, hard: torch.Tensor,
            message_only: bool = True) -> torch.Tensor:
    """The reference's check: decoded (message) bits all zero."""
    ncols = code.L - code.J if message_only else code.L
    return ~hard[:, :ncols].flatten(1).any(dim=1)


def _check(code: QCBinaryCode, hard: torch.Tensor, check: str) -> torch.Tensor:
    if check == "syndrome":
        return syndrome_ok(code, hard)
    if check == "zero":
        return zero_ok(code, hard)
    if check == "none":
        return torch.zeros(hard.shape[0], dtype=torch.bool, device=hard.device)
    raise ValueError(f"unknown check mode {check!r}")


def decode_flooding(chan: torch.Tensor, code: QCBinaryCode, num_iters: int,
                    alpha: float = 1.0, beta: float = 0.0,
                    check: str = "syndrome",
                    early_stop: bool = True) -> DecodeResult:
    """Flooding min-sum decode of chan [B, L, Z] (float32 channel values).

    Stops after ``num_iters`` iterations, or earlier once every frame's
    check passes when ``early_stop`` (check 'none' never passes).  The CN
    update of the final iteration is skipped: its messages would be
    discarded, and the outputs are those of the JAX function, which
    computes and drops them."""
    if check not in CHECKS:
        raise ValueError(f"unknown check mode {check!r}")
    B, dev = chan.shape[0], chan.device
    chan = chan.to(torch.float32)
    hard = torch.zeros((B, code.L, code.Z), dtype=torch.bool, device=dev)
    ok = torch.zeros(B, dtype=torch.bool, device=dev)
    R = torch.zeros((B, code.num_edges, code.Z), dtype=torch.float32,
                    device=dev)
    it = 0
    # the JAX loop condition, first tested on the all-False initial ok
    stop = num_iters <= 0 or (early_stop and bool(ok.all()))
    while not stop:
        _, hard, Q = _vn_update(code, chan, R)
        ok = _check(code, hard, check)
        it += 1
        stop = it >= num_iters or (early_stop and bool(ok.all()))
        if not stop:
            R = _cn_update(code, Q, alpha, beta)
    return DecodeResult(hard.to(torch.int8), ok,
                        torch.tensor(it, dtype=torch.int32, device=dev))
