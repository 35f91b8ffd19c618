"""The stateful step of the binary stream engine, plain PyTorch
(counterpart of cuda_ldpc_tpu/ops/pallas_minsum_stream.py:40-190, the TPU
kernel K4, without its TPU layout: no col-major [L, B, Zp] tiles, no
128-lane padding, no [B, 128] replicated flags).

It runs up to ``k`` passes of ``minsum.build_core`` over persistent
per-slot state.  A pass decides, checks and accounts, then runs the
check-node phase for the slots that go on:

* a slot that was running finishes when its check passes or its count
  ``t`` has reached ``max_iters``; ``okf`` records the check, ``done`` is
  set, and the slot is frozen for the rest of the call;
* a slot that goes on counts one more iteration in ``t``;
* the call ends after ``k`` passes, or earlier once no slot goes on.

``hard`` comes from the totals after the loop: the last decide's for
flooding, the running totals for layered (for a finished slot both are its
decisions at the pass it finished).  A finished slot leaves with its R
zeroed, so that the engine refills only its channel values.  Every pass
decides every slot, so a slot that was already finished on entry gets its
decisions too (the TPU kernel runs no pass when every slot is finished on
entry; the engines never call it so).

This is the reference that ops/cuda_minsum_stream.py's kernel equals bit
for bit on the card (for bp: the same operations), and it is held against
the JAX kernel in interpret mode on the CPU.

``compress_messages`` and ``expand_messages`` are the plain form of the
representation the min-sum kernel keeps on chip between its entry and its
exit: a min-sum check node's outputs take two magnitudes, v1 on every edge
but the first minimum and v2 on that edge, and a sign each, so (v1, v2,
the first-minimum index, the outputs' sign bits) is the row's R bit for bit,
-0.0 included.  Nothing on the card's path calls them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
from cuda_ldpc_torch.ops import minsum


def check_state(chan: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                done: torch.Tensor, okf: torch.Tensor, code: QCBinaryCode,
                k: int):
    """Raise on a state the step does not take (the kernel wrapper shares
    it)."""
    B = chan.shape[0]
    if tuple(chan.shape) != (B, code.L, code.Z) or chan.dtype != torch.float32:
        raise ValueError(f"chan must be float32 [B, {code.L}, {code.Z}], got "
                         f"{chan.dtype} {tuple(chan.shape)}")
    if (tuple(R.shape) != (B, code.num_edges, code.Z)
            or R.dtype != torch.float32):
        raise ValueError(f"R must be float32 [{B}, {code.num_edges}, "
                         f"{code.Z}], got {R.dtype} {tuple(R.shape)}")
    for name, x in (("t", t), ("done", done), ("okf", okf)):
        if tuple(x.shape) != (B,) or x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [{B}], got {x.dtype} "
                             f"{tuple(x.shape)}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")


def stream_step(chan: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                done: torch.Tensor, okf: torch.Tensor, code: QCBinaryCode,
                k: int, max_iters: int, alpha: float = 1.0, beta: float = 0.0,
                check: str = "zero", rule: str = "minsum",
                layered: bool = False):
    """Up to ``k`` passes over the slots' state: chan [B, L, Z] float32
    (flooding: the channel values; layered: the running totals), R
    [B, E, Z] float32, t / done / okf [B] int32.  The state is updated in
    place; returns (chan, R, hard [B, L, Z] int8, t, done, okf)."""
    check_state(chan, R, t, done, okf, code, k)
    minsum.check_args(check, rule)
    core = minsum.build_core(code, rule=rule,
                             schedule="layered" if layered else "flooding",
                             alpha=alpha, beta=beta)
    carry = (chan, R)
    fin_all = done.bool()
    tt, ok_flag = t.clone(), okf.bool()
    for _ in range(k):
        hard, total = core.decide(carry)
        ok = minsum._check(code, hard, check)
        fin = ~fin_all & (ok | (tt >= max_iters))
        ok_flag = torch.where(fin, ok, ok_flag)
        fin_all = fin_all | fin
        cont = ~fin_all
        tt = tt + cont.to(torch.int32)
        if not bool(cont.any()):
            break
        carry = core.step(carry, total, cont)
    if layered:
        chan.copy_(carry[0])
        hard = carry[0] < 0
    R.copy_(minsum._freeze(fin_all, torch.zeros_like(R), carry[1]))
    t.copy_(tt)
    done.copy_(fin_all)
    okf.copy_(ok_flag)
    return chan, R, hard.to(torch.int8), t, done, okf


class CompressedMessages(NamedTuple):
    """A min-sum R [B, E, Z] per check node (block row j, row lane r):
    edge i of the row carries ``v2`` if i == ``am`` else ``v1`` (both
    non-negative), negated where bit i of ``signs`` is set."""
    v1: torch.Tensor      # [B, J, Z] float32
    v2: torch.Tensor      # [B, J, Z] float32
    am: torch.Tensor      # [B, J, Z] int64, the first-minimum edge's index
    signs: torch.Tensor   # [B, J, Z] int64, the outputs' sign bits


def _row_messages(code: QCBinaryCode, R: torch.Tensor, j: int):
    """Row j's messages, row-aligned: [B, dc, Z], element (i, r) the
    message of edge row_edges[j][i] at z = (r + s) % Z."""
    return torch.stack([torch.roll(R[:, e], -int(code.edges[e, 2]), dims=-1)
                        for e in code.row_edges[j]], dim=1)


def compress_messages(R: torch.Tensor,
                      code: QCBinaryCode) -> CompressedMessages:
    """R [B, E, Z] float32 as written by the min-sum check node (or zeros)
    -> its compressed form.  The first-minimum edge is the one whose
    magnitude differs from the others'; where all agree, index 0."""
    v1s, v2s, ams, sgs = [], [], [], []
    for j in range(code.J):
        Rr = _row_messages(code, R, j)
        dc = Rr.shape[1]
        bits = (Rr.view(torch.int32) < 0).to(torch.int64)
        sgs.append((bits << torch.arange(dc, device=R.device)[:, None])
                   .sum(dim=1))
        mag = Rr.abs()
        mag0 = mag[:, 0]
        odd = mag[:, 1:] != mag0[:, None]                 # [B, dc-1, Z]
        first = odd.to(torch.int32).argmax(dim=1) + 1     # first that differs
        any_odd = odd.any(dim=1)
        mag_first = mag.gather(1, first[:, None].to(torch.int64))[:, 0]
        # edge 0 is the odd one when edges 1 and 2 agree against it
        zero_odd = (any_odd & (first == 1) & (mag[:, 2] == mag[:, 1])
                    if dc >= 3 else torch.zeros_like(any_odd))
        am = torch.where(any_odd & ~zero_odd, first, 0).to(torch.int64)
        v1s.append(torch.where(zero_odd, mag[:, 1], mag0))
        v2s.append(torch.where(any_odd & ~zero_odd, mag_first, mag0))
        ams.append(am)
    return CompressedMessages(*(torch.stack(x, dim=1)
                                for x in (v1s, v2s, ams, sgs)))


def expand_messages(c: CompressedMessages, code: QCBinaryCode) -> torch.Tensor:
    """The compressed form -> R [B, E, Z] float32."""
    B, _, Z = c.v1.shape
    R = torch.empty((B, code.num_edges, Z), dtype=torch.float32,
                    device=c.v1.device)
    for j in range(code.J):
        for i, e in enumerate(code.row_edges[j]):
            mag = torch.where(c.am[:, j] == i, c.v2[:, j], c.v1[:, j])
            neg = ((c.signs[:, j] >> i) & 1).bool()
            R[:, e] = torch.roll(torch.where(neg, -mag, mag),
                                 int(code.edges[e, 2]), dims=-1)
    return R
