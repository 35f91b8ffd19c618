"""Wrapper of the CUDA GF(q) max-domain decoder csrc/nbms.cu (K8): flooding
EMS at the reference's committed Nm = 2, Nc = 2 (myNBLDPC/include/
define.h:37-39), flooding TMM and row-layered TMM (counterpart of
cuda_ldpc_tpu/ops/pallas_nbms.py:517-543).

It replaces the TPU kernel ``pallas_nbms._kernel`` on the adjacency codes
whose rows all have the same degree: BDS.576.288.GF.64,
LDPC_N576_K288_GF64_d1_exp and, beyond the TPU kernel's q <= 64, the two
GF(256) codes.  ``supports`` states the rule: q = 2^m from 32 to 256, 2 to
32 edges per row, every row full, one frame's totals [N, q] and the row
scratch in a block's shared memory.  Left to the plain version (and
refused under ``auto`` on a card): EMS with another (Nm, Nc), full EMS,
grouped-layered TMM, rows of unequal degree (the Tanner code, q = 16).

One frame's totals [N, q] live in a block's shared memory, its c2v
messages [E, q] in device memory (a scratch [B, E, q]).  The block runs
the check rows of a pass on ``groups(plan, method)`` row groups at once
(csrc/qspa_common.cuh): flooding EMS and TMM every row of a pass at once,
layered TMM by dependency level (``cuda_qspa.row_waves``), so the outputs
are the serial schedule's bit for bit.  The serial design, one row at a
time on one group, stays callable as ``decode_*_serial``: chip_smoke.py and
the card tests hold the row groups to it and time them against it.  With
the messages in shared memory too (they fit on the GF(64) codes),
BDS.576.288.GF.64 at B=4096 ran 1.8-2x slower on the H100 in the serial
design (a 79 KB block left room for 2 blocks an SM instead of 7), and
slower at 1, 2 and 4 row groups too (PERF.md).

Semantics are ops/nb_decode.decode's for 'ems' (nm = nc = 2), 'tmm' and
'layered_tmm', bit for bit: every frame decides, checks and stops on its
own (a block per frame; the TPU kernel stops per 8-frame tile, which gives
the same outputs since stopped frames are frozen), so ``early_stop``
changes nothing in the outputs.  The TMM methods convert the channel to
the min domain here, with ``nb_decode.to_min_domain``.  The call enqueues
the conversion and one launch and returns without waiting.

A CPU tensor goes to the plain version in ops/nb_decode.py.  A CUDA tensor
goes to the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_ldpc_torch.models.nb_code import NBCode
from cuda_ldpc_torch.ops import _build, cuda_qspa, nb_decode
from cuda_ldpc_torch.ops.cuda_qspa import (SMEM_LIMIT, Plan, check_input,
                                           empty_result, make_plan)
from cuda_ldpc_torch.ops.nb_decode import NBDecodeResult

# Calls that launched the kernel, by method (the serial design's under
# nbms_serial_*); read and reset by chip_smoke.py to show that the main path
# went through it.
LAUNCHES = {"nbms_ems": 0, "nbms_tmm": 0, "nbms_layered_tmm": 0,
            "nbms_serial_ems": 0, "nbms_serial_tmm": 0,
            "nbms_serial_layered_tmm": 0}

METHOD_IDS = {"ems": 0, "tmm": 1, "layered_tmm": 2}


def smem_bytes(plan: Plan, groups: int = 1) -> int:
    """The kernel's dynamic shared memory per block (csrc/nbms.cu
    smem_bytes): T [N, q] and, for each row group, two row scratches
    [max_dc, q] and one [max(max_dc, 7), q] and 96 per-edge scalars, in
    f32; the GF tables and the decisions in int32."""
    q, dc = plan.q, plan.max_dc
    return 4 * (plan.N * q + groups * (2 * dc * q + max(dc, 7) * q + 96)
                + q + 2 * (q - 1) + plan.N)


def groups(plan: Plan, method: str) -> int:
    """Row groups of the kernel's block (``cuda_qspa.pick_groups``), one
    for layered TMM: on BDS.576.288.GF.64 its row groups ran slower than
    one group (10.35 ms with 2, 10.65 with 4, against 9.87; NVIDIA H100,
    PERF.md), since the 2-deviation search, which holds the SM busy,
    does not gain from more rows at once, and the levels' barriers and
    fewer frames an SM cost more than the overlap gives."""
    if method == "layered_tmm":
        return 1
    return cuda_qspa.pick_groups(plan, lambda g: smem_bytes(plan, g))


def blocks_per_sm(plan: Plan, method: str, groups: int,
                  device: torch.device) -> int:
    """Blocks of the kernel an SM of ``device`` holds with ``groups`` row
    groups (CUDA's occupancy calculator)."""
    return _build.load().ldpc_nbms_blocks_per_sm(
        plan.q, METHOD_IDS[method], groups, plan.N, plan.max_dc, device.index)


def supports(code: NBCode, nm: int = 2, nc: int = 2) -> bool:
    """True when the kernel takes the code (module docstring); ``nm``/``nc``
    gate EMS, whose kernel runs Nm = Nc = 2 only (TMM callers pass the
    defaults)."""
    if (nm, nc) != (2, 2):
        return False
    if code.q & (code.q - 1) or not 32 <= code.q <= 256:
        return False
    if not code.cn_mask.all():
        return False
    plan = make_plan(code)
    return 2 <= plan.max_dc <= 32 and smem_bytes(plan) <= SMEM_LIMIT


def _decode(L_ch: torch.Tensor, code: NBCode, max_iters: int, method: str,
            early_stop: bool, serial: bool = False) -> NBDecodeResult:
    if L_ch.device.type == "cpu":
        return nb_decode.decode(L_ch, code, method, max_iters,
                                early_stop=early_stop)
    if L_ch.device.type != "cuda":
        raise ValueError(f"unsupported device {L_ch.device}")
    if not supports(code):
        raise ValueError(f"the nbms kernel does not take {code.name} "
                         f"(q={code.q}, max_dc={code.max_dc})")
    plan = make_plan(code)
    check_input(L_ch, plan.N, plan.q)
    B, dev = L_ch.shape[0], L_ch.device
    if B == 0 or max_iters <= 0:
        return empty_result(B, plan.N, dev)
    chan = L_ch if method == "ems" else nb_decode.to_min_domain(L_ch)
    lib = _build.load()
    tables = cuda_qspa._device_tables(plan, cuda_qspa.code_key(code), dev)
    schedule = ("serial" if serial else
                "layered" if method == "layered_tmm" else "flooding")
    wave_ptr, wave_row, nwaves = cuda_qspa.device_waves(code, schedule, dev)
    C = torch.empty((B, plan.E, plan.q), dtype=torch.float32, device=dev)
    res = NBDecodeResult(torch.empty((B, plan.N), dtype=torch.int32,
                                     device=dev),
                         torch.empty(B, dtype=torch.bool, device=dev),
                         torch.empty(B, dtype=torch.int32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = cuda_qspa._ptr
    err = lib.ldpc_nbms(
        ptr(chan), ptr(C), *(ptr(t) for t in res), *(ptr(t) for t in tables),
        ptr(wave_ptr), ptr(wave_row), nwaves,
        1 if serial else groups(plan, method), B, plan.N, plan.M, plan.E,
        plan.q, plan.max_dc, int(max_iters), METHOD_IDS[method], dev.index,
        ctypes.c_void_p(stream))
    name = f"nbms_{'serial_' if serial else ''}{method}"
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ldpc_error_string(err).decode())
    LAUNCHES[name] += 1
    return res


def decode_ems(L_ch: torch.Tensor, code: NBCode, max_iters: int,
               early_stop: bool = True) -> NBDecodeResult:
    """Flooding EMS, Nm = Nc = 2, of L_ch [B, N, q] float32 symbol LLRs;
    drop-in for ops/nb_decode.decode_ems at its defaults."""
    return _decode(L_ch, code, max_iters, "ems", early_stop)


def decode_tmm(L_ch: torch.Tensor, code: NBCode, max_iters: int,
               early_stop: bool = True) -> NBDecodeResult:
    """Flooding TMM of positive-domain L_ch [B, N, q] float32; drop-in for
    ops/nb_decode.decode_tmm."""
    return _decode(L_ch, code, max_iters, "tmm", early_stop)


def decode_layered_tmm(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                       early_stop: bool = True) -> NBDecodeResult:
    """Row-layered TMM of positive-domain L_ch [B, N, q] float32; drop-in
    for ops/nb_decode.decode_layered_tmm."""
    return _decode(L_ch, code, max_iters, "layered_tmm", early_stop)


def decode_ems_serial(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                      early_stop: bool = True) -> NBDecodeResult:
    """``decode_ems`` in the serial design (one row at a time): the
    yardstick of the row groups, called only by chip_smoke.py and the card
    tests."""
    return _decode(L_ch, code, max_iters, "ems", early_stop, serial=True)


def decode_tmm_serial(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                      early_stop: bool = True) -> NBDecodeResult:
    """``decode_tmm`` in the serial design (see ``decode_ems_serial``)."""
    return _decode(L_ch, code, max_iters, "tmm", early_stop, serial=True)


def decode_layered_tmm_serial(L_ch: torch.Tensor, code: NBCode,
                              max_iters: int,
                              early_stop: bool = True) -> NBDecodeResult:
    """``decode_layered_tmm`` in the serial design (see
    ``decode_ems_serial``)."""
    return _decode(L_ch, code, max_iters, "layered_tmm", early_stop,
                   serial=True)
