"""Wrapper of the CUDA stream step csrc/minsum_stream.cu (K4): flooding or
layered, min-sum or bp, up to k passes over persistent per-slot state
(counterpart of cuda_ldpc_tpu/ops/pallas_minsum_stream.py:120-190).

It replaces the TPU kernel ``pallas_minsum_stream._stream_kernel`` and
computes what ops/minsum_stream.stream_step computes, bit for bit for
min-sum, with the same contract: chan (flooding: channel values; layered:
running totals) [B, L, Z], R [B, E, Z], t / done / okf [B] int32, updated in
place; hard [B, L, Z] int8 returned.  One launch per call, one block per
slot; the call returns without waiting.

A CPU tensor goes to the plain version.  A CUDA tensor goes to the kernel,
or the call raises.
"""

from __future__ import annotations

import torch

from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
from cuda_ldpc_torch.ops import _build, cuda_minsum, minsum, minsum_stream

# Calls that launched the kernel, by "<rule>_<schedule>"; read and reset by
# chip_smoke.py to show that the main path went through it.
LAUNCHES = {"minsum_stream_flooding": 0, "minsum_stream_layered": 0,
            "bp_stream_flooding": 0, "bp_stream_layered": 0}


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
    minsum_stream.check_state(chan, R, t, done, okf, code, k)
    minsum.check_args(check, rule)
    if not all(x.is_contiguous() and x.device == chan.device
               for x in (chan, R, t, done, okf)):
        raise ValueError("the state must be contiguous tensors on one device")
    lib = _build.load()
    if int(code.row_weights.max()) > lib.ldpc_max_row_degree():
        raise ValueError(f"{code.name}: row degree {code.row_weights.max()} "
                         f"exceeds the kernel's {lib.ldpc_max_row_degree()}")
    B, L, Z = chan.shape
    dev = chan.device
    hard = torch.empty((B, L, Z), dtype=torch.int8, device=dev)
    if B == 0:
        return chan, R, hard, t, done, okf
    T = chan if layered else torch.empty_like(chan)
    ptr = cuda_minsum._ptr
    err = lib.ldpc_minsum_stream(
        ptr(chan), ptr(T), ptr(R), ptr(hard), ptr(t), ptr(done), ptr(okf),
        *(ptr(x) for x in cuda_minsum._cached_tables(code, dev)), B, L,
        code.J, code.num_edges, Z, int(k), int(max_iters), float(alpha),
        int(alpha != 1.0), float(beta), int(beta != 0.0),
        cuda_minsum._CHECK_CODES[check], cuda_minsum._RULE_CODES[rule],
        int(bool(layered)), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    name = f"{rule}_stream_{'layered' if layered else 'flooding'}"
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ldpc_error_string(err).decode())
    LAUNCHES[name] += 1
    return chan, R, hard, t, done, okf
