"""Binary LDPC decoding on the lifted circulant structure, plain PyTorch:
flooding and row-layered schedules, min-sum and exact sum-product (bp)
check-node rules, and ``build_core``, the per-iteration core the stream
engines drive (counterpart of cuda_ldpc_tpu/ops/minsum.py:33-194 and
222-356).

This is the reference the CUDA kernels (ops/cuda_minsum.py) are held against
on the card, and it is held against the JAX package on the CPU: bit-exactly
for min-sum; for bp, whose log/tanh come from another library on each side,
ok and iters exactly and hard on every frame whose check passed.  Its
arithmetic therefore follows the JAX function operation by operation:

* VN totals add the channel value and then each c2v message one at a time
  in ``code.col_edges[l]`` order (a reassociating ``torch.sum`` would change
  the last bits);
* signs are taken with ``q < 0``; the CN writes min2 on the FIRST minimum
  edge (``argmin`` tie rule) and min1 elsewhere; beta is applied before
  alpha;
* bp sums phi in row-edge order one add at a time, and clips exactly
  where the JAX function does;
* layered computes every Q of a block row from the totals as they stand
  before that row's updates, then updates the totals edge by edge as
  ``T + (R_new - R_old)`` (the TPU kernel's ``(T + R_new) - R_old`` rounds
  differently);
* ``hard``/``ok`` come from the last iteration, ``iters`` counts the
  iterations the whole batch ran (batch-global early stop).

Messages are ``[B, E, Z]``; the circulant is ``torch.roll`` along Z.  The
early-stop test reads ``ok.all()`` on the host once per iteration, which
synchronises with the device: fine for a reference, and the reason the
kernel keeps its stop flag on the device instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cuda_ldpc_torch.models.qc_binary import QCBinaryCode

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


def _phi(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = -log(tanh(x/2)), self-inverse on x > 0."""
    return -torch.log(torch.tanh(x * 0.5))


def _cn_bp(Qr: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """Exact sum-product CN update on row-aligned [B, dc, Z]: the
    reference's declared but never implemented decoder_method=1
    (bldpc_实习/define.cuh:33-34), in the stable form
    R_i = prod(sgn) * sgn_i * phi(sum_j phi|Q_j| - phi|Q_i|).

    Not scale-invariant: Qr must be true LLRs 2y/sigma^2.  |Q| is clipped
    to [1.4e-7, 34] and the rest sum at 1.4e-7, which keeps phi finite;
    phi is summed in row-edge order, one add at a time."""
    sgn = torch.where(Qr < 0, -1.0, 1.0).to(Qr.dtype)
    sign_prod = torch.prod(sgn, dim=1, keepdim=True)
    ph = _phi(torch.clamp(Qr.abs(), 1.4e-7, 34.0))
    total = ph[:, 0]
    for i in range(1, Qr.shape[1]):
        total = total + ph[:, i]
    out = _phi(torch.clamp_min(total.unsqueeze(1) - ph, 1.4e-7))
    if beta:
        out = torch.clamp_min(
            out - torch.tensor(beta, dtype=Qr.dtype, device=Qr.device), 0)
    if alpha != 1.0:
        out = out * torch.tensor(alpha, dtype=Qr.dtype, device=Qr.device)
    return sign_prod * sgn * out


_CN_RULES = {"minsum": _cn_minsum, "bp": _cn_bp}


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
               beta: float, rule: str = "minsum") -> torch.Tensor:
    """CN phase for every block row: new c2v messages [B, E, Z]."""
    cn = _CN_RULES[rule]
    newR = [None] * code.num_edges
    for j in range(code.J):
        Rr = cn(_row_stack(code, Q, j), alpha, beta)
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


def check_args(check: str, rule: str):
    """Raise ValueError for an unknown check mode or rule (the kernel
    wrappers share it)."""
    if check not in CHECKS:
        raise ValueError(f"unknown check mode {check!r}")
    if rule not in _CN_RULES:
        raise ValueError(f"unknown rule {rule!r} (expected minsum|bp)")


def _decode(chan: torch.Tensor, code: QCBinaryCode, num_iters: int,
            check: str, early_stop: bool, iterate) -> DecodeResult:
    """The JAX while loop shared by both schedules: ``iterate()`` runs one
    iteration and returns the totals whose signs are the decisions."""
    B, dev = chan.shape[0], chan.device
    hard = torch.zeros((B, code.L, code.Z), dtype=torch.bool, device=dev)
    ok = torch.zeros(B, dtype=torch.bool, device=dev)
    it = 0
    # the JAX loop condition, first tested on the all-False initial ok
    stop = num_iters <= 0 or (early_stop and bool(ok.all()))
    while not stop:
        hard = iterate() < 0
        ok = _check(code, hard, check)
        it += 1
        stop = it >= num_iters or (early_stop and bool(ok.all()))
    return DecodeResult(hard.to(torch.int8), ok,
                        torch.tensor(it, dtype=torch.int32, device=dev))


def decode_flooding(chan: torch.Tensor, code: QCBinaryCode, num_iters: int,
                    alpha: float = 1.0, beta: float = 0.0,
                    check: str = "syndrome", early_stop: bool = True,
                    rule: str = "minsum") -> DecodeResult:
    """Flooding decode of chan [B, L, Z] (float32 channel values; true LLRs
    2y/sigma^2 for ``rule='bp'``, while min-sum takes raw samples).

    Stops after ``num_iters`` iterations, or earlier once every frame's
    check passes when ``early_stop`` (check 'none' never passes).  Each
    iteration's CN update is made at the start of the next one, so the
    final iteration's is skipped: the JAX function computes and drops
    those messages, so the outputs are the same."""
    check_args(check, rule)
    chan = chan.to(torch.float32)
    state = {"R": torch.zeros((chan.shape[0], code.num_edges, code.Z),
                              dtype=torch.float32, device=chan.device),
             "Q": None}

    def iterate() -> torch.Tensor:
        if state["Q"] is not None:      # the previous iteration's CN phase
            state["R"] = _cn_update(code, state["Q"], alpha, beta, rule)
        total, _, state["Q"] = _vn_update(code, chan, state["R"])
        return total

    return _decode(chan, code, num_iters, check, early_stop, iterate)


def decode_layered(chan: torch.Tensor, code: QCBinaryCode, num_iters: int,
                   alpha: float = 1.0, beta: float = 0.0,
                   check: str = "syndrome", early_stop: bool = True,
                   rule: str = "minsum") -> DecodeResult:
    """Row-layered decode of chan [B, L, Z]: each block row's CN update goes
    into the running totals at once (the schedule named in the BASELINE
    configs; with bp it needs about half the flooding iterations).
    Stopping and outputs as in ``decode_flooding``; hard and ok come from
    the totals after each full pass over the block rows."""
    check_args(check, rule)
    total = chan.to(torch.float32).clone()
    R = torch.zeros((chan.shape[0], code.num_edges, code.Z),
                    dtype=torch.float32, device=chan.device)

    def iterate() -> torch.Tensor:
        _layered_pass(code, total, R, alpha, beta, rule)
        return total

    return _decode(chan, code, num_iters, check, early_stop, iterate)


def _layered_pass(code: QCBinaryCode, total: torch.Tensor, R: torch.Tensor,
                  alpha: float, beta: float, rule: str):
    """One pass over the block rows, updating ``total`` [B, L, Z] and ``R``
    [B, E, Z] in place."""
    cn = _CN_RULES[rule]
    edges = code.edges
    for j in range(code.J):
        idx = code.row_edges[j]
        cols = [int(edges[e, 1]) for e in idx]
        shifts = [int(edges[e, 2]) for e in idx]
        # every Q of the row from the totals before the row's updates
        Qr = torch.stack([torch.roll(total[:, l] - R[:, e], -s, dims=-1)
                          for e, l, s in zip(idx, cols, shifts)], dim=1)
        Rr = cn(Qr, alpha, beta)
        for i, (e, l, s) in enumerate(zip(idx, cols, shifts)):
            new_col = torch.roll(Rr[:, i], s, dims=-1)
            total[:, l] = total[:, l] + (new_col - R[:, e])
            R[:, e] = new_col


def _freeze(cont: torch.Tensor, new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    """``new`` on the frames where cont [B] is set, ``old`` elsewhere."""
    return torch.where(cont.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


class BinaryCore(NamedTuple):
    """A binary decoder in per-iteration pieces, for the stream engines
    (counterpart of cuda_ldpc_tpu/ops/minsum.py:222-310).  The carry holds
    all per-frame state, the channel values included, so that an engine can
    put fresh frames into finished slots with one select.

    init(chan [B, L, Z]) -> carry
    decide(carry)        -> (hard [B, L, Z] bool, totals)
    step(carry, totals, cont [B] bool) -> carry   (frozen where ~cont)
    """
    init: object
    decide: object
    step: object


def build_core(code: QCBinaryCode, rule: str = "minsum",
               schedule: str = "flooding", alpha: float = 1.0,
               beta: float = 0.0) -> BinaryCore:
    """Per-iteration core of the flooding or layered decoder.  An iteration
    computes what decode_flooding's and decode_layered's do, in the same
    order, except that each frame is frozen where ``cont`` is not set (the
    batch decoders update every frame until the whole batch stops)."""
    check_args("zero", rule)

    def init(chan):
        chan = chan.to(torch.float32)
        return (chan, torch.zeros((chan.shape[0], code.num_edges, code.Z),
                                  dtype=torch.float32, device=chan.device))

    if schedule == "flooding":
        def decide(carry):
            chan, R = carry
            total, hard, _ = _vn_update(code, chan, R)
            return hard, total

        def step(carry, total, cont):
            chan, R = carry
            edge_l = torch.as_tensor(code.edges[:, 1], device=R.device)
            newR = _cn_update(code, total[:, edge_l, :] - R, alpha, beta, rule)
            return (chan, _freeze(cont, newR, R))

        return BinaryCore(init, decide, step)

    if schedule == "layered":
        def decide(carry):
            total, _ = carry
            return total < 0, total

        def step(carry, total_unused, cont):
            total0, R0 = carry
            total, R = total0.clone(), R0.clone()
            _layered_pass(code, total, R, alpha, beta, rule)
            return (_freeze(cont, total, total0), _freeze(cont, R, R0))

        return BinaryCore(init, decide, step)

    raise ValueError(f"unknown schedule {schedule!r}")
