"""Wrapper of the CUDA GF(q) max-domain decoder csrc/nbms.cu (K8): flooding
EMS at the reference's committed Nm = 2, Nc = 2 (myNBLDPC/include/
define.h:37-39) and at any other (Nm, Nc), flooding full EMS (the
reference's decoder_method 2), flooding TMM, row-layered TMM and
grouped-layered TMM (counterpart of cuda_ldpc_tpu/ops/pallas_nbms.py:
517-543, which compiles EMS 2/2, TMM and layered TMM; the JAX package runs
full EMS, EMS at other (Nm, Nc) and grouped-layered TMM in jnp,
cuda_ldpc_tpu/ops/nb_decode.py:371, :223 and :603).

It replaces the TPU kernel ``pallas_nbms._kernel`` on the adjacency codes
whose rows all have the same degree: BDS.576.288.GF.64,
LDPC_N576_K288_GF64_d1_exp and, beyond the TPU kernel's q <= 64, the two
GF(256) codes.  ``supports`` states the rule: q = 2^m from 32 to 256, 2 to
32 edges per row, every row full, one frame's totals [N, q] and the row
scratch in a block's shared memory (full EMS and EMS at (Nm, Nc) keep their
per-edge vectors and, but for the budgeted chains, their (max,+) chains
[dc, q] in the same scratch, so the rule is one for every method; the
budgeted chains' kept levels, ``budget_floats``, join the block, which
LDPC_N576_K480_GF256_exp holds at every Nc it budgets), and for EMS every
(Nm, Nc) that ``nb_decode.check_ems`` accepts.  Left to the plain
version (and refused under ``auto`` on a card): rows of unequal degree
(the Tanner code, q = 16).

EMS at (Nm, Nc) other than (2, 2) is K8's fifth mode (``ems_nmnc``): each
row takes the branch of ``nb_decode._ems_cn_core`` that (Nm, Nc, dc)
selects (``ems_branch``): conf(q,1) only; the pairs conf(Nm, 2); the
unbudgeted (max,+) chains (Nc >= dc - 1); or the chains budgeted by
deviation count (3 <= Nc <= dc - 2, on the four codes only
LDPC_N576_K480_GF256_exp, dc = 12), whose states a row group keeps in
shared memory at only the levels the function reads (``budget_floats``).
The set of an edge's top Nm - 1 offsets, by ``jax.lax.top_k``'s rule for
ties, is found in min(Nm - 1, q - Nm + 1) rounds of two warp reductions:
as first maxima, or, past q / 2, as all but the last offsets.  The chains
and full EMS convolve nothing with the identity, and a chain's step
against a message of few entries runs over those entries only
(csrc/nbms.cu's header).

The earlier design of both modes (every convolution, every budget level
and term, the budget states in device memory with a grid of the blocks
the card holds) stays as a yardstick: ``decode_ems_full_dense`` and
``decode_ems_nmnc_dense`` (modes ``ems_full_dense``, ``ems_nmnc_dense``),
called by chip_smoke.py's timing and parity and the card tests, never by
the decode path.

One frame's totals [N, q] live in a block's shared memory, its c2v
messages [E, q] in device memory (a scratch [B, E, q]).  The block runs
the check rows of a pass on ``groups(plan, method)`` row groups at once
(csrc/qspa_common.cuh): flooding EMS, full EMS and TMM every row of a pass
at once, layered TMM by dependency level, grouped-layered TMM (the layered
mode) by the greedy row groups of ``nb_decode.row_groups``
(``cuda_qspa.row_waves``), so the outputs are the plain schedule's bit for
bit.  With the messages in shared memory too (they fit on the GF(64)
codes), BDS.576.288.GF.64 at B=4096 ran 1.8-2x slower on the H100 with
one row at a time (a 79 KB block left room for 2 blocks an SM instead of
7), and slower at 1, 2 and 4 row groups too (PERF.md).

Semantics are ops/nb_decode.decode's for 'ems' (any Nm, Nc), 'ems_full',
'tmm', 'layered_tmm' and 'glayered_tmm', bit for bit: every frame
decides, checks and stops on its own (a block per frame; the TPU kernel
stops per 8-frame tile, which gives the same outputs since stopped frames
are frozen), so ``early_stop`` changes nothing in the outputs.  The TMM
methods convert the channel to the min domain here, with
``nb_decode.to_min_domain``.  The call enqueues the conversion and one
launch and returns without waiting.

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
            "nbms_ems_full": 0, "nbms_ems_nmnc": 0, "nbms_glayered_tmm": 0,
            "nbms_ems_full_dense": 0, "nbms_ems_nmnc_dense": 0}

# The kernel's mode of each method: grouped-layered TMM is the layered-TMM
# mode on other waves (``SCHEDULES``); the two ``_dense`` modes are the
# yardstick.
METHOD_IDS = {"ems": 0, "tmm": 1, "layered_tmm": 2, "ems_full": 3,
              "ems_nmnc": 4, "glayered_tmm": 2, "ems_full_dense": 5,
              "ems_nmnc_dense": 6}
# Each method's plain version (``nb_decode.decode``'s method).
PLAIN = {"ems_nmnc": "ems", "ems_nmnc_dense": "ems",
         "ems_full_dense": "ems_full"}
# The wave plan (``cuda_qspa.row_waves``) of each method; flooding else.
SCHEDULES = {"layered_tmm": "layered", "glayered_tmm": "glayered"}


def ems_branch(nm: int, nc: int, dc: int) -> str:
    """The branch of ``nb_decode._ems_cn_core`` that EMS at (nm, nc) takes
    on rows of dc edges (csrc/nbms.cu ``ems_branch``): 'conf1', 'pairs',
    'chains' (unbudgeted) or 'budget'."""
    if nc < 2 or nm < 2 or dc < 3:
        return "conf1"
    if nc == 2:
        return "pairs"
    return "chains" if nc >= dc - 1 else "budget"


def budget_levels(dc: int, nc: int) -> int:
    """Vectors [q] of one budgeted chain (csrc/nbms.cu ``level_base(dc)``):
    a state of s = 1 .. dc - 1 messages keeps its levels max(1, nc - (dc -
    1 - s)) .. min(s, nc), the only ones the function reads (a state
    equals its level s above it, level 0 is the identity, and no later
    step or exclusive term reads a lower level)."""
    return sum(min(s, nc) - max(1, nc - (dc - 1 - s)) + 1
               for s in range(1, dc))


def budget_floats(plan: Plan, nc: int) -> int:
    """Floats of one row group's budget region in shared memory (csrc/
    nbms.cu ``budget_floats``): the identity and both chains' kept
    levels."""
    return (1 + 2 * budget_levels(plan.max_dc, nc)) * plan.q


def dense_budget_floats(plan: Plan, nc: int) -> int:
    """Floats of one row group's budget states in device memory for the
    yardstick ``ems_nmnc_dense`` (csrc/nbms.cu ``dense_budget_floats``):
    the forward and backward chains [dc, nc + 1, q]."""
    return 2 * plan.max_dc * (nc + 1) * plan.q


def group_budget(plan: Plan, method: str, nm: int = 2, nc: int = 2) -> int:
    """Floats of each row group's budget region: ``budget_floats`` for
    ``ems_nmnc`` where its rows take the budgeted chains, else 0."""
    if method == "ems_nmnc" and ems_branch(nm, nc, plan.max_dc) == "budget":
        return budget_floats(plan, nc)
    return 0


def smem_bytes(plan: Plan, groups: int = 1, budget: int = 0) -> int:
    """The kernel's dynamic shared memory per block (csrc/nbms.cu
    smem_bytes): T [N, q] and, for each row group, two row scratches
    [max_dc, q] and one [max(max_dc, 7), q], 96 per-edge scalars and
    ``budget`` floats (``group_budget``), in f32; the GF tables and the
    decisions in int32."""
    q, dc = plan.q, plan.max_dc
    return 4 * (plan.N * q + groups * (2 * dc * q + max(dc, 7) * q + 96
                                       + budget)
                + q + 2 * (q - 1) + plan.N)


def groups(plan: Plan, method: str, nm: int = 2, nc: int = 2) -> int:
    """Row groups of the kernel's block (``cuda_qspa.pick_groups``), one
    for the layered TMM schedules: on BDS.576.288.GF.64 (B=4096, 10
    passes, 0 dB; NVIDIA H100, ``python -m
    cuda_ldpc_torch.tools.nb_rows_phases --groups 1,2,4``, PERF.md) layered
    TMM took 9.80 ms on one group, 10.35 on 2, 10.65 on 4, and
    grouped-layered TMM, whose 4 waves hold 3-17 rows against layered's 8
    levels, 9.80 / 10.32 / 10.31: the 2-deviation search, which holds the
    SM busy, does not gain from more rows at once, and the waves' barriers
    and fewer frames an SM cost more than the overlap gives.  One too for
    EMS at (nm, nc) with budgeted chains: csrc/nbms.cu compiles them into
    one-group blocks only, where their code costs the other branches
    nothing (PERF.md, PR 19)."""
    if method in ("layered_tmm", "glayered_tmm") or group_budget(
            plan, method, nm, nc):
        return 1
    return cuda_qspa.pick_groups(plan, lambda g: smem_bytes(plan, g))


def blocks_per_sm(plan: Plan, method: str, groups: int,
                  device: torch.device, nm: int = 2, nc: int = 2) -> int:
    """Blocks of the kernel an SM of ``device`` holds with ``groups`` row
    groups (CUDA's occupancy calculator; EMS's nm, nc size the budget
    region)."""
    return _build.load().ldpc_nbms_blocks_per_sm(
        plan.q, METHOD_IDS[method], groups, plan.N, plan.max_dc, int(nm),
        int(nc), device.index)


def supports(code: NBCode, nm: int = 2, nc: int = 2) -> bool:
    """True when the kernel takes the code (module docstring) and EMS's
    ``nm``/``nc``: every pair that ``nb_decode.check_ems`` accepts and
    whose budget region fits the block (full EMS and TMM callers pass the
    defaults)."""
    try:
        nb_decode.check_ems(nm, nc, code.q, code.max_dc)
    except ValueError:
        return False
    if code.q & (code.q - 1) or not 32 <= code.q <= 256:
        return False
    if not code.cn_mask.all():
        return False
    plan = make_plan(code)
    return 2 <= plan.max_dc <= 32 and smem_bytes(
        plan, 1, group_budget(plan, "ems_nmnc", nm, nc)) <= SMEM_LIMIT


def _grid(plan: Plan, method: str, G: int, B: int, dev: torch.device,
          nm: int, nc: int) -> int:
    """The blocks the card holds at once for the kernel, at most B."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return min(B, max(1, blocks_per_sm(plan, method, G, dev, nm, nc)) * sms)


def _decode(L_ch: torch.Tensor, code: NBCode, max_iters: int, method: str,
            early_stop: bool, nm: int = 2, nc: int = 2) -> NBDecodeResult:
    if L_ch.device.type == "cpu":
        return nb_decode.decode(L_ch, code, PLAIN.get(method, method),
                                max_iters, nm=nm, nc=nc,
                                early_stop=early_stop)
    if L_ch.device.type != "cuda":
        raise ValueError(f"unsupported device {L_ch.device}")
    if PLAIN.get(method) == "ems":
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
    wave_ptr, wave_row, nwaves = cuda_qspa.device_waves(
        code, SCHEDULES.get(method, "flooding"), dev)
    C = torch.empty((B, plan.E, plan.q), dtype=torch.float32, device=dev)
    res = NBDecodeResult(torch.empty((B, plan.N), dtype=torch.int32,
                                     device=dev),
                         torch.empty(B, dtype=torch.bool, device=dev),
                         torch.empty(B, dtype=torch.int32, device=dev))
    G, grid, scratch = groups(plan, method, nm, nc), B, None
    if (method == "ems_nmnc_dense"
            and ems_branch(nm, nc, plan.max_dc) == "budget"):
        grid = _grid(plan, method, G, B, dev, nm, nc)
        scratch = torch.empty(grid * G * dense_budget_floats(plan, nc),
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


def decode_ems_full_dense(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                          early_stop: bool = True) -> NBDecodeResult:
    """``decode_ems_full`` through the earlier design of its mode (every
    convolution, the identity's too): the yardstick, for chip_smoke.py and
    the card tests only."""
    return _decode(L_ch, code, max_iters, "ems_full_dense", early_stop)


def decode_ems_nmnc_dense(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                          nm: int, nc: int,
                          early_stop: bool = True) -> NBDecodeResult:
    """EMS at (nm, nc) through the earlier design of the mode ``ems_nmnc``
    (every level and term of the chains, the budget states in device
    memory): the yardstick, for chip_smoke.py and the card tests only."""
    return _decode(L_ch, code, max_iters, "ems_nmnc_dense", early_stop, nm,
                   nc)


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


def decode_glayered_tmm(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                        early_stop: bool = True) -> NBDecodeResult:
    """Grouped-layered TMM of positive-domain L_ch [B, N, q] float32 (the
    layered-TMM mode on the ``row_groups`` waves); drop-in for
    ops/nb_decode.decode(..., 'glayered_tmm')."""
    return _decode(L_ch, code, max_iters, "glayered_tmm", early_stop)
