"""Wrapper of the CUDA stream step csrc/minsum_stream.cu (K4): flooding or
layered, min-sum or bp, up to k passes over persistent per-slot state
(counterpart of cuda_ldpc_tpu/ops/pallas_minsum_stream.py:120-190).

It replaces the TPU kernel ``pallas_minsum_stream._stream_kernel`` and
computes what ops/minsum_stream.stream_step computes, bit for bit for
min-sum, with the same contract: chan (flooding: channel values; layered:
running totals) [B, L, Z], R [B, E, Z], t / done / okf [B] int32, updated in
place; hard [B, L, Z] int8 returned.  One launch per call; the call returns
without waiting.

Min-sum keeps each slot's working state on chip for the whole call: R is
read and compressed once at entry (two magnitudes, the first-minimum index
and the outputs' sign bits per check node: ops/minsum_stream's
``compress_messages`` is its plain form), T and the compressed state stay
in shared memory for all k passes, and R is expanded and written once at
exit.  A code whose state exceeds one block's shared memory runs on a
thread-block cluster that holds it in distributed shared memory;
``onchip_plan`` (ops/onchip.py, shared with the batch decoders K1 and K2)
picks the cluster size and lays the state out.  The grid is
persistent: as many clusters as fit on the card, each walking over slots.
bp keeps R in device memory, one block per slot, with the per-edge-phi
check node (the global-memory design; ``global_stream_step`` runs the same
design with the min-sum rule, for comparison only).

A CPU tensor goes to the plain version.  A CUDA tensor goes to the kernel,
or the call raises.
"""

from __future__ import annotations

import torch

from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
from cuda_ldpc_torch.ops import _build, cuda_minsum, minsum, minsum_stream
from cuda_ldpc_torch.ops.onchip import OnChipPlan, cached_plan, device_tables

# Calls that launched the kernel, by "<rule>_<schedule>"; read and reset by
# chip_smoke.py to show that the main path went through it.
LAUNCHES = {"minsum_stream_flooding": 0, "minsum_stream_layered": 0,
            "bp_stream_flooding": 0, "bp_stream_layered": 0}

def _check_cuda_state(chan, R, t, done, okf, code, k, check, rule):
    minsum_stream.check_state(chan, R, t, done, okf, code, k)
    minsum.check_args(check, rule)
    if not all(x.is_contiguous() and x.device == chan.device
               for x in (chan, R, t, done, okf)):
        raise ValueError("the state must be contiguous tensors on one device")


def onchip_step(chan: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                done: torch.Tensor, okf: torch.Tensor, code: QCBinaryCode,
                k: int, max_iters: int, alpha: float = 1.0, beta: float = 0.0,
                check: str = "zero", layered: bool = False,
                plan: OnChipPlan | None = None):
    """The min-sum stream step on CUDA tensors with the state on chip, laid
    out by ``plan`` (default: ``onchip_plan(code, layered)``, raising its
    ValueError for a code no plan holds); what
    ``stream_step`` runs for min-sum."""
    _check_cuda_state(chan, R, t, done, okf, code, k, check, "minsum")
    if plan is None:
        plan = cached_plan(code, layered)
    B, L, Z = chan.shape
    dev = chan.device
    hard = torch.empty((B, L, Z), dtype=torch.int8, device=dev)
    if B == 0:
        return chan, R, hard, t, done, okf
    lib = _build.load()
    ptr = cuda_minsum._ptr
    err = lib.ldpc_minsum_stream(
        ptr(chan), ptr(R), ptr(hard), ptr(t), ptr(done), ptr(okf),
        *(ptr(x) for x in cuda_minsum._cached_tables(code, dev)),
        *(ptr(x) for x in device_tables(code, plan, dev)), B, L, code.J,
        code.num_edges, Z, int(k), int(max_iters), float(alpha),
        int(alpha != 1.0), float(beta), int(beta != 0.0),
        cuda_minsum._CHECK_CODES[check], int(bool(layered)), plan.cluster,
        plan.smem_bytes, int(plan.wide), plan.threads, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    name = f"minsum_stream_{'layered' if layered else 'flooding'}"
    cuda_minsum._raise_on(err, lib, name)
    LAUNCHES[name] += 1
    return chan, R, hard, t, done, okf


def _global_launch(chan, R, t, done, okf, code, k, max_iters, alpha, beta,
                   check, rule, layered):
    _check_cuda_state(chan, R, t, done, okf, code, k, check, rule)
    lib = _build.load()
    max_dc = int(code.row_weights.max())
    if max_dc > lib.ldpc_max_row_degree():
        raise ValueError(f"{code.name}: row degree {max_dc} exceeds the "
                         f"kernel's {lib.ldpc_max_row_degree()}")
    B, L, Z = chan.shape
    dev = chan.device
    hard = torch.empty((B, L, Z), dtype=torch.int8, device=dev)
    if B == 0:
        return chan, R, hard, t, done, okf, 0
    T = chan if layered else torch.empty_like(chan)
    ptr = cuda_minsum._ptr
    err = lib.ldpc_minsum_stream_global(
        ptr(chan), ptr(T), ptr(R), ptr(hard), ptr(t), ptr(done), ptr(okf),
        *(ptr(x) for x in cuda_minsum._cached_tables(code, dev)), B, L,
        code.J, code.num_edges, Z, int(k), int(max_iters), float(alpha),
        int(alpha != 1.0), float(beta), int(beta != 0.0),
        cuda_minsum._CHECK_CODES[check], cuda_minsum._RULE_CODES[rule],
        int(bool(layered)), max_dc, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_minsum._raise_on(err, lib, f"{rule}_stream")
    return chan, R, hard, t, done, okf, 1


def global_stream_step(chan: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                       done: torch.Tensor, okf: torch.Tensor,
                       code: QCBinaryCode, k: int, max_iters: int,
                       alpha: float = 1.0, beta: float = 0.0,
                       check: str = "zero", rule: str = "minsum",
                       layered: bool = False):
    """The global-memory design (R and a T scratch in device memory, one
    block per slot) on CUDA tensors, uncounted.  Nothing in the package
    calls it with the min-sum rule: chip_smoke.py and the card tests hold
    the on-chip design to it and time the two in turns."""
    return _global_launch(chan, R, t, done, okf, code, k, max_iters, alpha,
                          beta, check, rule, layered)[:6]


def stream_step(chan: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                done: torch.Tensor, okf: torch.Tensor, code: QCBinaryCode,
                k: int, max_iters: int, alpha: float = 1.0, beta: float = 0.0,
                check: str = "zero", rule: str = "minsum",
                layered: bool = False):
    """Drop-in for ops/minsum_stream.stream_step."""
    if chan.device.type == "cpu":
        return minsum_stream.stream_step(chan, R, t, done, okf, code, k,
                                         max_iters, alpha=alpha, beta=beta,
                                         check=check, rule=rule,
                                         layered=layered)
    if chan.device.type != "cuda":
        raise ValueError(f"unsupported device {chan.device}")
    if rule == "minsum":
        return onchip_step(chan, R, t, done, okf, code, k, max_iters,
                           alpha=alpha, beta=beta, check=check,
                           layered=layered)
    *out, launched = _global_launch(chan, R, t, done, okf, code, k,
                                    max_iters, alpha, beta, check, rule,
                                    layered)
    LAUNCHES[f"{rule}_stream_{'layered' if layered else 'flooding'}"] += \
        launched
    return tuple(out)
