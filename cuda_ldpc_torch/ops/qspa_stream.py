"""The stateful step of the GF(q) stream engine, plain PyTorch
(counterpart of cuda_ldpc_tpu/ops/pallas_qspa_stream.py:136-276, the TPU
kernel K7, without its TPU work-arounds: no ``pack_chan`` lane padding, no
discrete-log lane order, no one-hot hard).

It runs up to ``k`` passes of ``nb_decode.build_core`` ('qspa' or
'layered_qspa') over persistent per-slot state.  A pass decides, checks the
GF syndrome and accounts, then runs the check rows for the slots that go
on:

* ``hard`` takes the pass's decisions on the slots that were running at its
  start (a slot finished on entry keeps zeros);
* a running slot finishes when its syndrome passes or its count ``t`` has
  reached ``max_iters``; ``okf`` records the syndrome, ``done`` is set;
* a slot that goes on counts one more iteration in ``t``;
* the call ends after ``k`` passes, or earlier once no slot goes on.

Layered returns its running totals in ``chan``.  A finished slot leaves with
its c2v messages zeroed.  The messages are kept as C [B, E, q] over the
real edges in the order of ops/cuda_qspa.make_plan (row by row, slot order),
which is the kernel's buffer; the plain core's [B, M, max_dc, q] is made
from it on entry and folded back on exit (the padded slots hold zeros).

This is the reference that ops/cuda_qspa_stream.py's kernel (K7) equals on
the card, and it is held against the JAX kernel in interpret mode on the
CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_ldpc_torch.models.nb_code import NBCode
from cuda_ldpc_torch.ops import nb_decode


def real_edges(code: NBCode) -> np.ndarray:
    """Flat indices into [M * max_dc] of the real edges, in plan order."""
    return np.flatnonzero(code.cn_mask.reshape(-1))


def check_state(chan: torch.Tensor, C: torch.Tensor, t: torch.Tensor,
                done: torch.Tensor, okf: torch.Tensor, code: NBCode, k: int):
    """Raise on a state the step does not take (the kernel wrapper shares
    it)."""
    B, q, E = chan.shape[0], code.q, int(code.cn_mask.sum())
    if tuple(chan.shape) != (B, code.n_sym, q) or chan.dtype != torch.float32:
        raise ValueError(f"chan must be float32 [B, {code.n_sym}, {q}], got "
                         f"{chan.dtype} {tuple(chan.shape)}")
    if tuple(C.shape) != (B, E, q) or C.dtype != torch.float32:
        raise ValueError(f"C must be float32 [{B}, {E}, {q}], got {C.dtype} "
                         f"{tuple(C.shape)}")
    for name, x in (("t", t), ("done", done), ("okf", okf)):
        if tuple(x.shape) != (B,) or x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [{B}], got {x.dtype} "
                             f"{tuple(x.shape)}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")


def stream_step(chan: torch.Tensor, C: torch.Tensor, t: torch.Tensor,
                done: torch.Tensor, okf: torch.Tensor, code: NBCode, k: int,
                max_iters: int, layered: bool = False):
    """Up to ``k`` passes over the slots' state: chan [B, N, q] float32
    (flooding: the channel LLRs; layered: the running totals), C [B, E, q]
    float32, t / done / okf [B] int32.  The state is updated in place;
    returns (chan, C, hard [B, N] int32, t, done, okf)."""
    check_state(chan, C, t, done, okf, code, k)
    core = nb_decode.build_core(code, "layered_qspa" if layered else "qspa",
                                chan.device)
    g = core.g
    B = chan.shape[0]
    idx = torch.as_tensor(real_edges(code), device=chan.device)
    c2v = torch.zeros((B, g.M * g.dc, g.q), dtype=torch.float32,
                      device=chan.device)
    c2v[:, idx] = C
    carry = (chan, c2v.reshape(B, g.M, g.dc, g.q))
    fin_all = done.bool()
    tt, ok_flag = t.clone(), okf.bool()
    hard = torch.zeros((B, g.N), dtype=torch.int32, device=chan.device)
    for _ in range(k):
        hard_new, llr = core.decide(carry)
        active = ~fin_all
        hard = nb_decode._freeze(active, hard_new, hard)
        ok = nb_decode._syndrome_ok(g, hard_new)
        fin = active & (ok | (tt >= max_iters))
        ok_flag = torch.where(fin, ok, ok_flag)
        fin_all = fin_all | fin
        cont = ~fin_all
        tt = tt + cont.to(torch.int32)
        if not bool(cont.any()):
            break
        carry = core.step(carry, llr, cont)
    if layered:
        chan.copy_(carry[0])
    msgs = carry[1].reshape(B, g.M * g.dc, g.q)[:, idx]
    C.copy_(nb_decode._freeze(fin_all, torch.zeros_like(msgs), msgs))
    t.copy_(tt)
    done.copy_(fin_all)
    okf.copy_(ok_flag)
    return chan, C, hard, t, done, okf
