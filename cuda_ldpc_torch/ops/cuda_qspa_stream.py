"""Wrapper of the CUDA GF(q) stream step csrc/qspa_stream.cu (K7): FFT-QSPA
flooding, serial-row layered or grouped-layered, up to k passes over
persistent per-slot state (counterpart of
cuda_ldpc_tpu/ops/pallas_qspa_stream.py:200-276; the JAX package runs the
grouped-layered stream core in jnp).

It replaces the TPU kernel ``pallas_qspa_stream._stream_kernel`` and
computes what ops/qspa_stream.stream_step computes, with the same contract:
chan (flooding: channel LLRs; the layered schedules: running totals) [B, N,
q], C [B, E, q], t / done / okf [B] int32, updated in place; hard [B, N]
int32 returned; ``layered`` False, True or 'glayered'
(``qspa_stream.schedule``).  It takes the codes K5 takes
(``cuda_qspa.supports``: the adjacency codes), as the TPU kernel takes
those of ``pallas_qspa``; the QC Tanner code has no stream kernel (ROADMAP
item 13).  One launch per call, one block per slot; the call returns
without waiting.  The block runs the check rows of a pass on
``groups(plan, layered)`` row groups at once (csrc/qspa_common.cuh),
walking ``cuda_qspa.row_waves``: flooding every row of a pass at once,
layered by dependency level, grouped-layered by the greedy row groups (the
layered kernel on other waves), bit for bit the plain schedule.  Each
slot's c2v messages stay in device memory: in shared memory (49 KB a slot
on BDS.576.288.GF.64) a block left 2 blocks an SM and the step ran slower
(PERF.md).

A CPU tensor goes to the plain version.  A CUDA tensor goes to the kernel,
or the call raises.
"""

from __future__ import annotations

import torch

from cuda_ldpc_torch.models.nb_code import NBCode
from cuda_ldpc_torch.ops import _build, cuda_qspa, nb_decode, qspa_stream

# Calls that launched the kernel, by schedule; read and reset by
# chip_smoke.py to show that the main path went through it.
LAUNCHES = {f"qspa_stream_{s}": 0 for s in nb_decode.QSPA_BY_SCHEDULE}


def supports(code: NBCode) -> bool:
    """The codes the kernel takes: K5's."""
    return cuda_qspa.supports(code)


def smem_bytes(plan: cuda_qspa.Plan, groups: int = 1) -> int:
    """The kernel's dynamic shared memory per block (csrc/qspa_stream.cu
    smem_bytes): K5's, with a row's spectra [max_dc, q] for each row
    group."""
    return cuda_qspa.smem_bytes(plan, groups)


def groups(plan: cuda_qspa.Plan, layered: bool) -> int:
    """Row groups of the kernel's block (``cuda_qspa.pick_groups``; a
    layered schedule, serial-row or grouped, takes its layered tie-break)."""
    return cuda_qspa.pick_groups(plan, lambda g: smem_bytes(plan, g),
                                 bool(layered))


def blocks_per_sm(plan: cuda_qspa.Plan, layered: bool, groups: int,
                  device: torch.device) -> int:
    """Blocks of the kernel an SM of ``device`` holds with ``groups`` row
    groups (CUDA's occupancy calculator)."""
    return _build.load().ldpc_qspa_stream_blocks_per_sm(
        plan.q, int(bool(layered)), groups, plan.N, plan.max_dc,
        device.index)


def stream_step(chan: torch.Tensor, C: torch.Tensor, t: torch.Tensor,
                done: torch.Tensor, okf: torch.Tensor, code: NBCode, k: int,
                max_iters: int, layered: bool | str = False):
    """Drop-in for ops/qspa_stream.stream_step."""
    schedule = qspa_stream.schedule(layered)
    if chan.device.type == "cpu":
        return qspa_stream.stream_step(chan, C, t, done, okf, code, k,
                                       max_iters, layered=layered)
    if chan.device.type != "cuda":
        raise ValueError(f"unsupported device {chan.device}")
    if not supports(code):
        raise ValueError(f"the qspa stream kernel does not take {code.name} "
                         f"(q={code.q}, max_dc={code.max_dc})")
    qspa_stream.check_state(chan, C, t, done, okf, code, k)
    if not all(x.is_contiguous() and x.device == chan.device
               for x in (chan, C, t, done, okf)):
        raise ValueError("the state must be contiguous tensors on one device")
    plan = cuda_qspa.make_plan(code)
    B, dev = chan.shape[0], chan.device
    hard = torch.empty((B, plan.N), dtype=torch.int32, device=dev)
    if B == 0:
        return chan, C, hard, t, done, okf
    lib = _build.load()
    tables = cuda_qspa._device_tables(plan, cuda_qspa.code_key(code), dev)
    wave_ptr, wave_row, nwaves = cuda_qspa.device_waves(code, schedule, dev)
    ptr = cuda_qspa._ptr
    layered = schedule != "flooding"
    err = lib.ldpc_qspa_stream(
        ptr(chan), ptr(C), ptr(hard), ptr(t), ptr(done), ptr(okf),
        *(ptr(x) for x in tables), ptr(wave_ptr), ptr(wave_row), nwaves,
        groups(plan, layered), B, plan.N, plan.M, plan.E, plan.q,
        plan.max_dc, int(k), int(max_iters), int(layered), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    name = f"qspa_stream_{schedule}"
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ldpc_error_string(err).decode())
    LAUNCHES[name] += 1
    return chan, C, hard, t, done, okf
