"""Wrapper of the CUDA GF(q) max-domain decoder csrc/nbms.cu (K8): flooding
EMS at the reference's committed Nm = 2, Nc = 2 (myNBLDPC/include/
define.h:37-39) and at any other (Nm, Nc), flooding full EMS (the
reference's decoder_method 2), flooding TMM and row-layered TMM
(counterpart of cuda_ldpc_tpu/ops/pallas_nbms.py:517-543, which compiles
EMS 2/2, TMM and layered TMM; the JAX package runs full EMS and EMS at
other (Nm, Nc) in jnp, cuda_ldpc_tpu/ops/nb_decode.py:371 and :223).

It replaces the TPU kernel ``pallas_nbms._kernel`` on the adjacency codes
whose rows all have the same degree: BDS.576.288.GF.64,
LDPC_N576_K288_GF64_d1_exp and, beyond the TPU kernel's q <= 64, the two
GF(256) codes.  ``supports`` states the rule: q = 2^m from 32 to 256, 2 to
32 edges per row, every row full, one frame's totals [N, q] and the row
scratch in a block's shared memory (full EMS and EMS at (Nm, Nc) keep their
per-edge vectors and, but for the budgeted chains, their (max,+) chains
[dc, q] in the same scratch, so the rule is one for every method), and for
EMS every (Nm, Nc) that ``nb_decode.check_ems`` accepts.  Left to the plain
version (and refused under ``auto`` on a card): grouped-layered TMM, rows
of unequal degree (the Tanner code, q = 16).

EMS at (Nm, Nc) other than (2, 2) is K8's fifth mode (``ems_nmnc``): each
row takes the branch of ``nb_decode._ems_cn_core`` that (Nm, Nc, dc)
selects (``ems_branch``): conf(q,1) only; the pairs conf(Nm, 2); the
unbudgeted (max,+) chains (Nc >= dc - 1); or the chains budgeted by
deviation count (3 <= Nc <= dc - 2, on the four codes only
LDPC_N576_K480_GF256_exp, dc = 12), whose states [2, dc, Nc + 1, q] a row
group keeps in device memory, one set per resident block: that launch has
as many blocks as the card holds at once, each decoding every grid-th
frame.  The set of an edge's top Nm - 1 offsets, by ``jax.lax.top_k``'s
rule for ties, is found in min(Nm - 1, q - Nm + 1) warp reductions: as
first maxima, or, past q / 2, as all but the last offsets.

One frame's totals [N, q] live in a block's shared memory, its c2v
messages [E, q] in device memory (a scratch [B, E, q]).  The block runs
the check rows of a pass on ``groups(plan, method)`` row groups at once
(csrc/qspa_common.cuh): flooding EMS, full EMS and TMM every row of a pass
at once, layered TMM by dependency level (``cuda_qspa.row_waves``), so the
outputs are the serial schedule's bit for bit.  With the messages in
shared memory too (they fit on the GF(64) codes), BDS.576.288.GF.64 at
B=4096 ran 1.8-2x slower on the H100 with one row at a time (a 79 KB
block left room for 2 blocks an SM instead of 7), and slower at 1, 2 and
4 row groups too (PERF.md).

Semantics are ops/nb_decode.decode's for 'ems' (any Nm, Nc), 'ems_full',
'tmm' and 'layered_tmm', bit for bit: every frame decides, checks and stops on its
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

# Calls that launched the kernel, by method; read and reset by
# chip_smoke.py to show that the main path went through it.
LAUNCHES = {"nbms_ems": 0, "nbms_tmm": 0, "nbms_layered_tmm": 0,
            "nbms_ems_full": 0, "nbms_ems_nmnc": 0}

METHOD_IDS = {"ems": 0, "tmm": 1, "layered_tmm": 2, "ems_full": 3,
              "ems_nmnc": 4}


def ems_branch(nm: int, nc: int, dc: int) -> str:
    """The branch of ``nb_decode._ems_cn_core`` that EMS at (nm, nc) takes
    on rows of dc edges (csrc/nbms.cu ``ems_branch``): 'conf1', 'pairs',
    'chains' (unbudgeted) or 'budget'."""
    if nc < 2 or nm < 2 or dc < 3:
        return "conf1"
    if nc == 2:
        return "pairs"
    return "chains" if nc >= dc - 1 else "budget"


def budget_floats(plan: Plan, nc: int) -> int:
    """Floats of one row group's budget states (csrc/nbms.cu
    ``budget_floats``): the forward and backward chains [dc, nc + 1, q]."""
    return 2 * plan.max_dc * (nc + 1) * plan.q


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
    """True when the kernel takes the code (module docstring) and EMS's
    ``nm``/``nc``: every pair that ``nb_decode.check_ems`` accepts (full
    EMS and TMM callers pass the defaults)."""
    try:
        nb_decode.check_ems(nm, nc, code.q, code.max_dc)
    except ValueError:
        return False
    if code.q & (code.q - 1) or not 32 <= code.q <= 256:
        return False
    if not code.cn_mask.all():
        return False
    plan = make_plan(code)
    return 2 <= plan.max_dc <= 32 and smem_bytes(plan) <= SMEM_LIMIT


def _grid(plan: Plan, method: str, G: int, B: int, dev: torch.device) -> int:
    """The blocks the card holds at once for the kernel, at most B."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return min(B, max(1, blocks_per_sm(plan, method, G, dev)) * sms)


def _decode(L_ch: torch.Tensor, code: NBCode, max_iters: int, method: str,
            early_stop: bool, nm: int = 2, nc: int = 2) -> NBDecodeResult:
    if L_ch.device.type == "cpu":
        return nb_decode.decode(L_ch, code, "ems" if method == "ems_nmnc"
                                else method, max_iters, nm=nm, nc=nc,
                                early_stop=early_stop)
    if L_ch.device.type != "cuda":
        raise ValueError(f"unsupported device {L_ch.device}")
    if method == "ems_nmnc":
        nb_decode.check_ems(nm, nc, code.q, code.max_dc)
    if not supports(code, nm, nc):
        raise ValueError(f"the nbms kernel does not take {code.name} "
                         f"(q={code.q}, max_dc={code.max_dc})")
    plan = make_plan(code)
    check_input(L_ch, plan.N, plan.q)
    B, dev = L_ch.shape[0], L_ch.device
    if B == 0 or max_iters <= 0:
        return empty_result(B, plan.N, dev)
    chan = (nb_decode.to_min_domain(L_ch) if method in nb_decode.TMM_METHODS
            else L_ch)
    lib = _build.load()
    tables = cuda_qspa._device_tables(plan, cuda_qspa.code_key(code), dev)
    schedule = "layered" if method == "layered_tmm" else "flooding"
    wave_ptr, wave_row, nwaves = cuda_qspa.device_waves(code, schedule, dev)
    C = torch.empty((B, plan.E, plan.q), dtype=torch.float32, device=dev)
    res = NBDecodeResult(torch.empty((B, plan.N), dtype=torch.int32,
                                     device=dev),
                         torch.empty(B, dtype=torch.bool, device=dev),
                         torch.empty(B, dtype=torch.int32, device=dev))
    G, grid, scratch = groups(plan, method), B, None
    if method == "ems_nmnc" and ems_branch(nm, nc, plan.max_dc) == "budget":
        grid = _grid(plan, method, G, B, dev)
        scratch = torch.empty(grid * G * budget_floats(plan, nc),
                              dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = cuda_qspa._ptr
    err = lib.ldpc_nbms(
        ptr(chan), ptr(C), *(ptr(t) for t in res), *(ptr(t) for t in tables),
        ptr(wave_ptr), ptr(wave_row), nwaves, G, B, plan.N, plan.M, plan.E,
        plan.q, plan.max_dc, int(max_iters), METHOD_IDS[method], int(nm),
        int(nc), None if scratch is None else ptr(scratch), grid, dev.index,
        ctypes.c_void_p(stream))
    name = f"nbms_{method}"
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ldpc_error_string(err).decode())
    LAUNCHES[name] += 1
    return res


def decode_ems(L_ch: torch.Tensor, code: NBCode, max_iters: int,
               nm: int = 2, nc: int = 2,
               early_stop: bool = True) -> NBDecodeResult:
    """Flooding EMS with configuration sets conf(q,1) + conf(nm, nc) of
    L_ch [B, N, q] float32 symbol LLRs; drop-in for ops/nb_decode
    .decode_ems.  (2, 2) runs the mode ``ems``, any other pair the mode
    ``ems_nmnc``; a pair ``nb_decode.check_ems`` refuses raises."""
    return _decode(L_ch, code, max_iters,
                   "ems" if (nm, nc) == (2, 2) else "ems_nmnc", early_stop,
                   nm, nc)


def decode_ems_full(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                    early_stop: bool = True) -> NBDecodeResult:
    """Flooding full EMS (the reference's decoder_method 2: every
    configuration, exclusive forward/backward (max,+) convolutions) of L_ch
    [B, N, q] float32 symbol LLRs; drop-in for ops/nb_decode.decode_ems at
    ``full=True``."""
    return _decode(L_ch, code, max_iters, "ems_full", early_stop)


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
