"""Wrapper of the CUDA GF(q) FFT-QSPA decoder csrc/qspa.cu (K5), flooding
and serial-row layered (counterpart of cuda_ldpc_tpu/ops/pallas_qspa.py:
105-213 and 423-441).

It replaces the TPU kernel ``pallas_qspa._kernel`` on the adjacency codes
(BDS.576.288.GF.64, LDPC_N576_K288_GF64_d1_exp, LDPC_N96_K48_GF256_d1_exp,
LDPC_N576_K480_GF256_exp): q from 32 to 256, at most 32 edges per row, and
one frame's totals [N, q] in a block's shared memory.  The TPU kernel's
edge-count cap (E <= 640, statically unrolled rows) does not apply here.

Semantics are ops/nb_decode.decode_qspa's and decode_layered_qspa's, bit
for bit: every frame decides, checks and stops on its own, so ``early_stop``
changes nothing in the outputs (the plain version runs its batch until
every frame has stopped, with the stopped frames frozen).  The call
enqueues one launch and returns without waiting.

The kernel runs the check rows of a pass at once on the wave plan
``row_waves`` (flooding one wave of every row, layered the dependency
levels), bit for bit the serial schedule, in the layout ``row_layout``
picks: a whole row on one warp (``warps`` a block) where it fits, else a
warp an edge on ``groups`` row groups.  The serial design (one row at a
time) stays callable as ``decode_flooding_serial`` / ``decode_layered_serial``
and every design as ``decode_design``, for chip_smoke.py, the phase tool
and the card tests only.

A CPU tensor goes to the plain version in ops/nb_decode.py.  A CUDA tensor
goes to the kernel, or the call raises.

The adjacency codes' host tables live here for K7 and K8 too: the edge
plan (``make_plan``), the row waves their row groups walk (``row_waves``)
and the number of groups a block holds (``pick_groups``).
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from cuda_ldpc_torch.models.nb_code import NBCode
from cuda_ldpc_torch.ops import _build, nb_decode
from cuda_ldpc_torch.ops.nb_decode import NBDecodeResult
from cuda_ldpc_torch.utils import gf as gflib

# Calls that launched the kernel, by schedule: through decode_flooding /
# decode_layered under qspa_<schedule> and also under
# qspa_<design>_<schedule> for the design ``row_layout`` picks, through
# decode_design under qspa_<design>_<schedule> only; read and reset by
# chip_smoke.py to show that the main path went through it, in which layout.
DESIGNS = ("serial", "groups", "warp")
LAUNCHES = {f"qspa_{d}{s}": 0 for d in ("",) + tuple(x + "_" for x in DESIGNS)
            for s in ("flooding", "layered")}

# Dynamic shared memory a block of an H100 may use (cudaDevAttr-
# MaxSharedMemoryPerBlockOptin).
SMEM_LIMIT = 232_448
# What one H100 SM holds: shared memory (228 KB, of which the runtime
# reserves 1 KB a block), threads and blocks.
SM_SMEM, SM_BLOCK_RESERVE, SM_THREADS, SM_BLOCKS = 233_472, 1024, 2048, 32
# Row groups a block may hold: named barriers 1-7 (csrc/qspa_common.cuh
# kMaxGroups; 0 is __syncthreads).  A block of more than one group has at
# most 512 threads, and ptxas gives it 40 registers a thread (its launch
# bounds, kGroupedThreads and kGroupedBlocks; -Xptxas -v, PERF.md).
MAX_GROUPS, GROUPED_THREADS, GROUPED_REGISTERS = 7, 512, 40
SM_REGISTERS = 65_536


class Plan(NamedTuple):
    """A code's edge lists for the kernel (int32 numpy).  Edge e of row m
    is row_ptr[m] + slot, in the code's CN slot order."""
    N: int
    M: int
    E: int
    q: int
    max_dc: int
    row_ptr: np.ndarray     # [M+1]
    edge_vn: np.ndarray     # [E] VN of each edge
    edge_h: np.ndarray      # [E] GF coefficient of each edge
    col_ptr: np.ndarray     # [N+1]
    col_edge: np.ndarray    # [E] each VN's edges in its slot order
    gf_log: np.ndarray      # [q] log_alpha(a), a != 0
    gf_exp: np.ndarray      # [2(q-1)] alpha^i, doubled


def code_key(code: NBCode) -> tuple:
    """Content-based cache key (an id() could be reused by another code)."""
    blob = b"".join(np.ascontiguousarray(a).tobytes()
                    for a in (code.cn_links, code.cn_gf, code.cn_mask,
                              code.vn_links, code.vn_slot))
    return (code.name, code.n_sym, code.m_sym, code.q,
            hashlib.sha1(blob).hexdigest())


def gf_tables(q: int) -> tuple[np.ndarray, np.ndarray]:
    """(log [q], antilog doubled to [2(q-1)]) as int32: the kernels multiply
    and divide through them without a modulo."""
    exp, log = gflib.exp_log_tables(q)
    return (log.astype(np.int32),
            np.concatenate([exp, exp]).astype(np.int32))


_PLANS: dict[tuple, Plan] = {}


def make_plan(code: NBCode) -> Plan:
    key = code_key(code)
    if key not in _PLANS:
        w = code.cn_weight.astype(np.int64)
        row_ptr = np.concatenate([[0], np.cumsum(w)])
        real = code.cn_mask
        col = [row_ptr[code.vn_links[n, d]] + code.vn_slot[n, d]
               for n in range(code.n_sym) for d in range(code.vn_weight[n])]
        col_ptr = np.concatenate([[0], np.cumsum(code.vn_weight)])
        gf_log, gf_exp = gf_tables(code.q)
        i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
        _PLANS[key] = Plan(
            N=code.n_sym, M=code.m_sym, E=int(row_ptr[-1]), q=code.q,
            max_dc=int(w.max()), row_ptr=i32(row_ptr),
            edge_vn=i32(code.cn_links[real]), edge_h=i32(code.cn_gf[real]),
            col_ptr=i32(col_ptr), col_edge=i32(col), gf_log=gf_log,
            gf_exp=gf_exp)
    return _PLANS[key]


class Waves(NamedTuple):
    """A schedule's check rows for the row-group kernels (K7, K8): wave w
    is rows wave_row[wave_ptr[w]:wave_ptr[w + 1]], in ascending order; the
    rows of one wave may run at once (csrc/qspa_common.cuh)."""
    wave_ptr: np.ndarray    # [W+1] int32
    wave_row: np.ndarray    # [M] int32


WAVE_SCHEDULES = ("flooding", "layered", "serial")

_WAVES: dict[tuple, Waves] = {}


def dependency_levels(plan: Plan) -> np.ndarray:
    """[M] the serial-row layered schedule's dependency level of each row:
    0 for a row that shares no VN with an earlier row, else one more than
    the highest level of the earlier rows it shares a VN with.  Rows of one
    level touch disjoint VNs, and a row that shares a VN with a later row
    has the lower level, so running the levels in order, the rows of a level
    at once, updates every VN's totals in the serial order."""
    last = np.full(plan.N, -1, dtype=np.int64)
    level = np.zeros(plan.M, dtype=np.int64)
    for m in range(plan.M):
        vns = plan.edge_vn[plan.row_ptr[m]:plan.row_ptr[m + 1]]
        if len(vns):
            level[m] = last[vns].max() + 1
            last[vns] = level[m]
    return level


def row_waves(code: NBCode, schedule: str) -> Waves:
    """The rows of one pass as waves, cached per code: 'flooding' one wave
    of every row (a flooding pass's rows are independent); 'layered' the
    dependency levels (``dependency_levels``); 'serial' one wave a row, the
    serial design."""
    if schedule not in WAVE_SCHEDULES:
        raise ValueError(f"unknown wave schedule {schedule!r}")
    key = (code_key(code), schedule)
    if key not in _WAVES:
        plan = make_plan(code)
        level = {"flooding": np.zeros(plan.M, dtype=np.int64),
                 "layered": dependency_levels(plan),
                 "serial": np.arange(plan.M)}[schedule]
        order = np.argsort(level, kind="stable")
        ptr = np.concatenate([[0], np.cumsum(np.bincount(level,
                                                         minlength=1))])
        _WAVES[key] = Waves(np.ascontiguousarray(ptr, dtype=np.int32),
                            np.ascontiguousarray(order, dtype=np.int32))
    return _WAVES[key]


def pick_groups(plan: Plan, smem_of, layered: bool = False) -> int:
    """Row groups a block of a row-group kernel holds: of the G from 1 to
    7 whose block fits (32 * max_dc threads a group, 1024 threads for one
    group and 512 for more, smem_of(G) <= SMEM_LIMIT, G <= M), the one that
    puts the most row groups on an SM (its blocks an SM, by threads, by
    shared memory, by registers and by the block cap, times G).  On a tie,
    flooding takes the larger G (the same groups an SM, fewer frames, each
    sooner done) and layered the smaller (more frames an SM to cover the
    levels' block barriers): on BDS.576.288.GF.64 flooding ran fastest at
    G = 4 and layered at G = 2 (PERF.md)."""
    threads = 32 * plan.max_dc
    best, most = 1, 0
    for g in range(1, min(MAX_GROUPS, plan.M) + 1):
        if threads * g > (1024 if g == 1 else GROUPED_THREADS):
            break
        smem = smem_of(g)
        if smem > SMEM_LIMIT:
            break
        blocks = min(SM_THREADS // (threads * g), SM_BLOCKS,
                     SM_SMEM // (smem + SM_BLOCK_RESERVE))
        if g > 1:
            blocks = min(blocks, SM_REGISTERS // (GROUPED_REGISTERS
                                                  * threads * g))
        if blocks * g > most or (blocks * g == most and not layered):
            best, most = g, blocks * g
    return best


_wave_tables: dict = {}


def device_waves(code: NBCode, schedule: str, device: torch.device):
    """``row_waves`` on the device, once per code, schedule and device:
    (wave_ptr, wave_row, number of waves)."""
    k = code_key(code) + (schedule, str(device))
    if k not in _wave_tables:
        w = row_waves(code, schedule)
        _wave_tables[k] = (torch.as_tensor(w.wave_ptr, device=device),
                           torch.as_tensor(w.wave_row, device=device),
                           len(w.wave_ptr) - 1)
    return _wave_tables[k]


def smem_bytes(plan: Plan, groups: int = 1, c_on_chip: bool = False) -> int:
    """The kernel's dynamic shared memory per block (csrc/qspa.cu
    smem_bytes): T [N, q] and a row's spectra [max_dc, q] for each of
    ``groups`` row groups (none for a row on one warp, ``groups`` = 0) in
    f32, the GF tables and the decisions in int32, and the frame's C [E, q]
    f32 when it lives on chip."""
    return 4 * (plan.N * plan.q + groups * plan.max_dc * plan.q
                + (plan.E * plan.q if c_on_chip else 0)
                + plan.q + 2 * (plan.q - 1) + plan.N)


def supports(code: NBCode) -> bool:
    """True when the kernel takes the code: q = 2^m from 32 to 256, 1 to 32
    edges per row (a warp per edge), one frame's totals in shared memory."""
    if code.q & (code.q - 1) or not 32 <= code.q <= 256:
        return False
    plan = make_plan(code)
    return 1 <= plan.max_dc <= 32 and smem_bytes(plan) <= SMEM_LIMIT


# The launch bounds of a row on one warp (csrc/qspa.cu kWarpBounds), by
# schedule, flooding (False) and layered (True): (threads a block, blocks an
# SM).
WARP_BOUNDS = {False: (384, 3), True: (256, 4)}


def padded_degree(plan: Plan) -> int:
    """dc': the largest row degree rounded up to a power of two."""
    return 1 << (plan.max_dc - 1).bit_length()


def warp_fits(plan: Plan) -> bool:
    """A whole check row fits one warp where dc' q <= 256 (dc' lane groups
    of W = 32 / dc' lanes, q / W <= 8 symbols a lane).  The kernel is built
    for the registry's such codes, GF(64) with rows of 3 or 4 edges (dc' =
    4: W = 8 lanes an edge, 8 symbols a lane; lane t holds edge t // W and,
    in its register j, symbol t % W + W j); no registry code has q = 32.
    A flooding block also holds the frame's C (``c_on_chip``), so the
    layout takes a code only where that block fits."""
    return (plan.q == 64 and padded_degree(plan) == 4
            and smem_bytes(plan, 0, c_on_chip=True) <= SMEM_LIMIT)


def row_layout(plan: Plan) -> str:
    """The layout the kernel runs a check row in: 'warp' (a row on one
    warp) where ``warp_fits``, else 'groups' (a warp an edge on row
    groups).  Where a row fits a warp, the warp layout was the faster on
    BDS.576.288.GF.64 at B=4096, 10 passes, 0 dB, flooding and layered
    (PERF.md: chip_smoke.py's K5 turns and
    ``python -m cuda_ldpc_torch.tools.nb_rows_phases``)."""
    return "warp" if warp_fits(plan) else "groups"


def c_on_chip(layered: bool) -> bool:
    """Whether the row-a-warp layout keeps each frame's C [E, q] in shared
    memory: flooding does, layered does not (csrc/qspa.cu ties it to the
    schedule, and does not build the other two pairings).  On
    BDS.576.288.GF.64 (B=4096, 10 passes, 0 dB; the phase tool
    ``python -m cuda_ldpc_torch.tools.nb_rows_phases`` while it still built
    both places of C, PERF.md) flooding took 3.20 ms with C on chip
    at 12 warps a block against 3.50 in device memory at 8 (its totals
    waited on C: 45% of the cycles); layered took 3.06 in device memory at
    4 against 3.16 on chip at 12."""
    return not layered


def warps(layered: bool) -> int:
    """Warps a block of the row-a-warp layout, each walking its own rows
    of a wave: 12 flooding (3 frames, 36 warps an SM on BDS), 4 layered
    (8 frames, 32 warps an SM); the fastest of the sweep ``c_on_chip``
    names."""
    return 4 if layered else 12


def groups(plan: Plan, layered: bool) -> int:
    """Row groups of the warp-an-edge layout: ``pick_groups`` with K5's
    shared memory (BDS: 4 flooding, 2 layered) for q <= 64, one group for
    q >= 128.  A block of more than one group keeps to 40 registers a
    thread, and there ptxas spills for q >= 128 (56-180 bytes, -Xptxas
    -v); on LDPC_N96_K48_GF256_d1_exp (B=4096, 10 passes, 0 dB; ``python
    -m cuda_ldpc_torch.tools.nb_rows_phases --code LDPC_N96_K48_GF256_d1_exp
    --groups 1,2,4``, PERF.md) G = 4 / 2 took 2.80 / 3.52 ms
    against one group's 2.07 / 2.09, flooding / layered."""
    if plan.q >= 128:
        return 1
    return pick_groups(plan, lambda g: smem_bytes(plan, g), layered)


def launch_shape(plan: Plan, layered: bool, design: str) -> tuple[int, int]:
    """(layout, width) as csrc/qspa.cu's ldpc_qspa takes them: 'serial' a
    warp an edge on one group, 'groups' on ``groups`` row groups (layout
    0), 'warp' a row on one warp, ``warps`` warps a block (layout 1)."""
    if design == "serial":
        return 0, 1
    if design == "groups":
        return 0, groups(plan, layered)
    if design == "warp":
        if not warp_fits(plan):
            raise ValueError(f"a row of {plan.max_dc} edges over GF({plan.q})"
                             " does not fit one warp")
        return 1, warps(layered)
    raise ValueError(f"unknown design {design!r}")


def blocks_per_sm(plan: Plan, layered: bool, design: str,
                  device: torch.device) -> int:
    """Blocks of the design's kernel an SM of ``device`` holds (CUDA's
    occupancy calculator)."""
    layout, width = launch_shape(plan, layered, design)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _build.load().ldpc_qspa_blocks_per_sm(
        plan.q, int(layered), layout, width, plan.N, plan.E, plan.max_dc,
        index)


_tables: dict = {}


def _device_tables(plan: Plan, key: tuple, device: torch.device):
    """The plan's index tables go to the device once per code and device."""
    k = key + (str(device),)
    if k not in _tables:
        _tables[k] = [torch.as_tensor(a, device=device)
                      for a in (plan.row_ptr, plan.edge_vn, plan.edge_h,
                                plan.col_ptr, plan.col_edge, plan.gf_log,
                                plan.gf_exp)]
    return _tables[k]


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_input(L_ch: torch.Tensor, N: int, q: int):
    """Raise on what the kernels do not take."""
    if L_ch.dtype != torch.float32:
        raise TypeError(f"L_ch must be float32, got {L_ch.dtype}")
    if L_ch.dim() != 3 or tuple(L_ch.shape[1:]) != (N, q):
        raise ValueError(f"L_ch must be [B, {N}, {q}], got "
                         f"{tuple(L_ch.shape)}")
    if not L_ch.is_contiguous():
        raise ValueError("L_ch must be contiguous")


def empty_result(B: int, N: int, device: torch.device) -> NBDecodeResult:
    """The plain version's result when nothing is decoded (an empty batch
    or max_iters = 0): zeros, not ok, no iterations."""
    return NBDecodeResult(torch.zeros((B, N), dtype=torch.int32, device=device),
                          torch.zeros(B, dtype=torch.bool, device=device),
                          torch.zeros(B, dtype=torch.int32, device=device))


def _decode(L_ch: torch.Tensor, code: NBCode, max_iters: int, layered: bool,
            early_stop: bool, design: str | None = None) -> NBDecodeResult:
    if L_ch.device.type == "cpu":
        plain = (nb_decode.decode_layered_qspa if layered
                 else nb_decode.decode_qspa)
        return plain(L_ch, code, max_iters, early_stop=early_stop)
    if L_ch.device.type != "cuda":
        raise ValueError(f"unsupported device {L_ch.device}")
    if not supports(code):
        raise ValueError(f"the qspa kernel does not take {code.name} "
                         f"(q={code.q}, max_dc={code.max_dc})")
    plan = make_plan(code)
    check_input(L_ch, plan.N, plan.q)
    B, dev = L_ch.shape[0], L_ch.device
    main = design is None
    design = design or row_layout(plan)
    layout, width = launch_shape(plan, layered, design)
    if B == 0 or max_iters <= 0:
        return empty_result(B, plan.N, dev)
    lib = _build.load()
    tables = _device_tables(plan, code_key(code), dev)
    schedule = "layered" if layered else "flooding"
    wave_ptr, wave_row, nwaves = device_waves(
        code, "serial" if design == "serial" else schedule, dev)
    # a row on one warp keeps a flooding frame's C on chip: no buffer
    C = torch.empty((0,) if layout == 1 and c_on_chip(layered)
                    else (B, plan.E, plan.q), dtype=torch.float32, device=dev)
    res = NBDecodeResult(torch.empty((B, plan.N), dtype=torch.int32,
                                     device=dev),
                         torch.empty(B, dtype=torch.bool, device=dev),
                         torch.empty(B, dtype=torch.int32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ldpc_qspa(
        _ptr(L_ch), _ptr(C), *(_ptr(t) for t in res),
        *(_ptr(t) for t in tables), _ptr(wave_ptr), _ptr(wave_row), nwaves,
        layout, width, B, plan.N, plan.M, plan.E, plan.q, plan.max_dc,
        int(max_iters), int(layered), dev.index, ctypes.c_void_p(stream))
    name = f"qspa_{design}_{schedule}"
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ldpc_error_string(err).decode())
    LAUNCHES[name] += 1
    if main:
        LAUNCHES[f"qspa_{schedule}"] += 1
    return res


def decode_flooding(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                    early_stop: bool = True) -> NBDecodeResult:
    """Flooding FFT-QSPA of L_ch [B, N, q] float32 symbol LLRs; drop-in for
    ops/nb_decode.decode_qspa."""
    return _decode(L_ch, code, max_iters, False, early_stop)


def decode_layered(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                   early_stop: bool = True) -> NBDecodeResult:
    """Serial-row layered FFT-QSPA of L_ch [B, N, q] float32; drop-in for
    ops/nb_decode.decode_layered_qspa."""
    return _decode(L_ch, code, max_iters, True, early_stop)


def decode_design(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                  layered: bool, design: str,
                  early_stop: bool = True) -> NBDecodeResult:
    """``decode_flooding`` / ``decode_layered`` in the named design of
    ``DESIGNS`` ('serial': one row at a time; 'groups': a warp an edge on
    row groups; 'warp': a row on one warp), whatever ``row_layout`` picks:
    the yardsticks, called only by chip_smoke.py, the phase tool and the
    card tests."""
    return _decode(L_ch, code, max_iters, layered, early_stop, design)


def decode_flooding_serial(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                           early_stop: bool = True) -> NBDecodeResult:
    """``decode_flooding`` in the serial design (one row at a time): the
    yardstick of the rows at once."""
    return decode_design(L_ch, code, max_iters, False, "serial", early_stop)


def decode_layered_serial(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                          early_stop: bool = True) -> NBDecodeResult:
    """``decode_layered`` in the serial design (one row at a time): the
    yardstick of the rows at once."""
    return decode_design(L_ch, code, max_iters, True, "serial", early_stop)
