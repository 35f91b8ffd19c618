"""Wrapper of the CUDA GF(q) FFT-QSPA decoder on the quasi-cyclic structure,
csrc/qspa_qc.cu (K6), flooding and block-row layered (counterpart of
cuda_ldpc_tpu/ops/pallas_qspa_qc.py:87-198 and 453-472).

It replaces the TPU kernel ``pallas_qspa_qc._kernel`` on
Tanner_74_9_Z128_GF16.  The QC plan is extracted as the JAX package
extracts it (block edges keyed by block row, block column and shift; None
unless every circulant is complete and no block row meets a block column
twice); the kernel also needs q <= 32 (a group of q lanes per check row)
and the code's slot orders to follow the blocks (each row's VNs by block
column, each VN's checks by block row), which is how its exclusive products
and VN sums take the plain version's order.

Semantics: ``decode_flooding`` is ops/nb_decode.decode_qspa,
``decode_layered`` is the grouped-layered ``decode_glayered_qspa``, whose
conflict-free row groups on a QC code are its block rows in order; bit for
bit, with per-frame stopping as in ops/cuda_qspa.py.  Where those groups
are the block rows in row order (``layered_is_block_rows``; on
Tanner_74_9_Z128_GF16, its 9 block rows of 128 rows), the serial-row
``decode_layered_qspa`` is the same function (a block row's rows share no
VN), so ``decode_layered`` serves it too; on any other QC code the serial
order has no kernel (ROADMAP item 13).

Two designs compute it.  ``decode_flooding``/``decode_layered`` run the
staged kernel (``qspa_qc_kernel``): a block of THREADS threads takes a
frame, a chunk of THREADS / q check rows of one block row at a time, whose
totals and messages it copies into shared memory ahead of the arithmetic
(``stage_runs`` gives each chunk's copies), and it keeps the frame's
decisions in shared memory.  ``decode_flooding_global``/
``decode_layered_global`` run the earlier design (``qspa_qc_global_kernel``,
every gather from device memory in series); it stays as the yardstick that
chip_smoke.py and the card tests hold the staged kernel to, and nothing
else calls it.

A CPU tensor goes to the plain version.  A CUDA tensor goes to the kernel,
or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from cuda_ldpc_torch.models.nb_code import NBCode
from cuda_ldpc_torch.ops import _build, nb_decode
from cuda_ldpc_torch.ops.cuda_qspa import (SMEM_LIMIT, check_input, code_key,
                                           empty_result, gf_tables)
from cuda_ldpc_torch.ops.nb_decode import NBDecodeResult

LAUNCHES = {"qspa_qc_flooding": 0, "qspa_qc_layered": 0,
            "qspa_qc_flooding_global": 0, "qspa_qc_layered_global": 0}

THREADS = 256           # csrc/qspa_qc.cu kThreads
GLOBAL_THREADS = 512    # csrc/qspa_qc.cu kGlobalThreads


class QCPlan(NamedTuple):
    """A QC code's block structure."""
    NB: int                     # block columns
    MB: int                     # block rows
    Z: int                      # lifting factor
    q: int
    EB: int                     # nonzero circulant blocks ("block edges")
    row_edges: tuple            # per block row: tuple of (eid, c, shift)
    col_edges: tuple            # per block column: tuple of (eid, shift)
    hz: np.ndarray              # [EB, Z] GF coefficient of check row z


_PLANS: dict[tuple, QCPlan | None] = {}


def make_plan(code: NBCode) -> QCPlan | None:
    """Extract the QC structure (or None if the code is not fully QC with Z
    in 128 or 256), block edges sorted by (block row, block column,
    shift)."""
    key = code_key(code)
    if key not in _PLANS:
        _PLANS[key] = _build_plan(code)
    return _PLANS[key]


def _build_plan(code: NBCode) -> QCPlan | None:
    q = code.q
    if q & (q - 1) or not 4 <= q <= 64:
        return None
    for Z in (128, 256):
        if code.n_sym % Z == 0 and code.m_sym % Z == 0:
            break
    else:
        return None
    NB, MB = code.n_sym // Z, code.m_sym // Z
    # group edges into circulant blocks keyed by (block row, block col, shift)
    blocks: dict[tuple, dict] = {}
    for m in range(code.m_sym):
        bj, z = divmod(m, Z)
        for d in range(int(code.cn_weight[m])):
            v = int(code.cn_links[m, d])
            bc, cz = divmod(v, Z)
            s = (cz - z) % Z
            blocks.setdefault((bj, bc, s), {})[z] = int(code.cn_gf[m, d])
    seen_rc = set()
    for (bj, bc, s), zg in blocks.items():
        if len(zg) != Z:
            return None                   # incomplete circulant: not QC
        if (bj, bc) in seen_rc:
            return None                   # parallel block edges unsupported
        seen_rc.add((bj, bc))
    row_edges: list[list] = [[] for _ in range(MB)]
    col_edges: list[list] = [[] for _ in range(NB)]
    hz = []
    for eid, ((bj, bc, s), zg) in enumerate(sorted(blocks.items())):
        row_edges[bj].append((eid, bc, s))
        col_edges[bc].append((eid, s))
        hz.append([zg[z] for z in range(Z)])
    hz = np.array(hz, dtype=np.int64)
    if (hz == 0).any():
        return None                       # h = 0 on a live edge: malformed
    return QCPlan(NB=NB, MB=MB, Z=Z, q=q, EB=len(blocks),
                  row_edges=tuple(tuple(r) for r in row_edges),
                  col_edges=tuple(tuple(c) for c in col_edges), hz=hz)


def _slots_follow_blocks(code: NBCode) -> bool:
    """Each row lists its VNs, and each VN its checks, in ascending order:
    then the CN slots run by block column and the VN slots by block row."""
    def ascending(links, weight):
        return all(np.all(np.diff(links[i, :weight[i]]) > 0)
                   for i in range(links.shape[0]))
    return (ascending(code.cn_links, code.cn_weight)
            and ascending(code.vn_links, code.vn_weight))


def layered_is_block_rows(code: NBCode) -> bool:
    """True when ``nb_decode.row_groups`` of the code, concatenated, are
    its rows in order and each group is one of the QC plan's block rows:
    then the serial-row layered QSPA equals the grouped-layered one, the
    block-row schedule of ``decode_layered``."""
    plan = make_plan(code)
    if plan is None:
        return False
    g = nb_decode.build_graph(code)
    groups = nb_decode.row_groups(g.cn_links, g.cn_mask)
    return len(groups) == plan.MB and all(
        np.array_equal(rows, np.arange(bj * plan.Z, (bj + 1) * plan.Z))
        for bj, rows in enumerate(groups))


def _round16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(plan: QCPlan) -> int:
    """csrc/qspa_qc.cu staged_smem_bytes: two stages of [max_dc, THREADS]
    f32 totals and messages, two of [max_dc, THREADS / q] coefficient logs,
    the frame's decisions [N] as bytes and the int tables (GF, block
    edges, block columns)."""
    max_dc = max(len(r) for r in plan.row_edges)
    G = THREADS // plan.q
    return (4 * 4 * max_dc * THREADS + _round16(2 * max_dc * G)
            + _round16(plan.NB * plan.Z)
            + 4 * (plan.q + 2 * (plan.q - 1) + plan.MB + 1 + 3 * plan.EB
                   + plan.NB + 1))


def global_smem_bytes(q: int, max_dc: int) -> int:
    """csrc/qspa_qc.cu global_smem_bytes: two [max_dc, GLOBAL_THREADS] f32
    arrays and the GF tables."""
    return 4 * (2 * max_dc * GLOBAL_THREADS + q + 2 * (q - 1))


_SUPPORTS: dict[tuple, bool] = {}


def supports(code: NBCode) -> bool:
    """True when both designs take the code: a QC plan, q <= 32 (a group of
    q lanes a check row, a decision in a byte), slot orders that follow the
    blocks, and each design's shared memory within a block's."""
    key = code_key(code)
    if key not in _SUPPORTS:
        plan = make_plan(code)
        _SUPPORTS[key] = (
            plan is not None and plan.q <= 32 and _slots_follow_blocks(code)
            and smem_bytes(plan) <= SMEM_LIMIT
            and global_smem_bytes(plan.q, max(len(r) for r in plan.row_edges))
            <= SMEM_LIMIT)
    return _SUPPORTS[key]


def stage_runs(plan: QCPlan) -> np.ndarray:
    """[EB * Z / G, 4] int32, G = THREADS / q check rows a chunk: for chunk
    j of block row r (its rows j*G .. j*G + G-1) and the row's block edge d
    (entry blk_ptr[r] * Z / G + j * dc + d), where the kernel copies from:
    the VN (totals row) of the chunk's first check row, the number of rows
    before the circulant wraps, the VN after the wrap (the block column's
    first), and the message row of the chunk's first check row (eid * Z +
    j * G).  Check row j*G + i of the chunk reads VN t_row0 + i for i <
    t_split, else t_row1 + i - t_split."""
    Z, G = plan.Z, THREADS // plan.q
    out = []
    for row in plan.row_edges:
        for j in range(Z // G):
            for eid, c, s in row:
                start = (j * G + s) % Z
                out.append((c * Z + start, min(G, Z - start), c * Z,
                            eid * Z + j * G))
    return np.array(out, dtype=np.int32).reshape(-1, 4)


def coefficient_logs(plan: QCPlan) -> np.ndarray:
    """[EB * Z] uint8: log_alpha of each check row's coefficient, so that
    y / h = alpha^(log y + q - 1 - log h) takes one subtraction and one
    table read."""
    gf_log, _ = gf_tables(plan.q)
    return gf_log[plan.hz.reshape(-1)].astype(np.uint8)


class StagedTables(NamedTuple):
    """The plan as arrays, in the staged kernel's argument order."""
    blk_ptr: np.ndarray     # [MB+1] int32
    blk_c: np.ndarray       # [EB] block column of each block edge
    blk_s: np.ndarray       # [EB] shift of each block edge
    col_ptr: np.ndarray     # [NB+1]
    col_eid: np.ndarray     # [EB] each block column's edges, by block row
    lgh: np.ndarray         # [EB*Z] uint8, coefficient_logs
    runs: np.ndarray        # [EB*Z/G, 4] int32, stage_runs
    gf_log: np.ndarray
    gf_exp: np.ndarray


class KernelTables(NamedTuple):
    """The plan as int32 arrays, in the global kernel's argument order."""
    blk_ptr: np.ndarray     # [MB+1]
    blk_c: np.ndarray       # [EB] block column of each block edge
    blk_s: np.ndarray       # [EB] shift of each block edge
    hz: np.ndarray          # [EB*Z]
    col_ptr: np.ndarray     # [NB+1]
    col_eid: np.ndarray     # [EB] each block column's edges, by block row
    gf_log: np.ndarray
    gf_exp: np.ndarray


def _block_tables(plan: QCPlan) -> dict:
    edges = [e for row in plan.row_edges for e in row]    # eid order
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    gf_log, gf_exp = gf_tables(plan.q)
    return dict(
        blk_ptr=i32(np.cumsum([0] + [len(r) for r in plan.row_edges])),
        blk_c=i32([c for _, c, _ in edges]),
        blk_s=i32([s for _, _, s in edges]),
        col_ptr=i32(np.cumsum([0] + [len(c) for c in plan.col_edges])),
        col_eid=i32([eid for col in plan.col_edges for eid, _ in col]),
        gf_log=gf_log, gf_exp=gf_exp)


def staged_tables(plan: QCPlan) -> StagedTables:
    return StagedTables(lgh=coefficient_logs(plan), runs=stage_runs(plan),
                        **_block_tables(plan))


def kernel_tables(plan: QCPlan) -> KernelTables:
    return KernelTables(hz=np.ascontiguousarray(plan.hz.reshape(-1),
                                                dtype=np.int32),
                        **_block_tables(plan))


_tables: dict = {}


def _device_tables(plan: QCPlan, key: tuple, device: torch.device,
                   design: str):
    k = key + (str(device), design)
    if k not in _tables:
        make = staged_tables if design == "staged" else kernel_tables
        _tables[k] = [torch.as_tensor(a, device=device) for a in make(plan)]
    return _tables[k]


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _decode(L_ch: torch.Tensor, code: NBCode, max_iters: int, layered: bool,
            early_stop: bool, design: str = "staged") -> NBDecodeResult:
    if L_ch.device.type == "cpu":
        plain = (nb_decode.decode_glayered_qspa if layered
                 else nb_decode.decode_qspa)
        return plain(L_ch, code, max_iters, early_stop=early_stop)
    if L_ch.device.type != "cuda":
        raise ValueError(f"unsupported device {L_ch.device}")
    if not supports(code):
        raise ValueError(f"the QC qspa kernel does not take {code.name}")
    plan = make_plan(code)
    N = plan.NB * plan.Z
    check_input(L_ch, N, plan.q)
    B, dev = L_ch.shape[0], L_ch.device
    if B == 0 or max_iters <= 0:
        return empty_result(B, N, dev)
    lib = _build.load()
    tables = _device_tables(plan, code_key(code), dev, design)
    T = torch.empty_like(L_ch)
    C = torch.empty((B, plan.EB * plan.Z, plan.q), dtype=torch.float32,
                    device=dev)
    res = NBDecodeResult(torch.empty((B, N), dtype=torch.int32, device=dev),
                         torch.empty(B, dtype=torch.bool, device=dev),
                         torch.empty(B, dtype=torch.int32, device=dev))
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    max_dc = max(len(r) for r in plan.row_edges)
    name = "qspa_qc_layered" if layered else "qspa_qc_flooding"
    if design == "staged":
        err = lib.ldpc_qspa_qc(
            _ptr(L_ch), _ptr(T), _ptr(C), *(_ptr(t) for t in res),
            *(_ptr(t) for t in tables), B, plan.NB, plan.MB,
            plan.Z.bit_length() - 1, plan.EB, plan.q, max_dc, int(max_iters),
            int(layered), dev.index, stream)
    else:
        name += "_global"
        err = lib.ldpc_qspa_qc_global(
            _ptr(L_ch), _ptr(T), _ptr(C), *(_ptr(t) for t in res),
            *(_ptr(t) for t in tables), B, plan.NB, plan.MB, plan.Z, plan.EB,
            plan.q, max_dc, int(max_iters), int(layered), dev.index, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ldpc_error_string(err).decode())
    LAUNCHES[name] += 1
    return res


def decode_flooding(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                    early_stop: bool = True) -> NBDecodeResult:
    """Flooding FFT-QSPA on the QC structure; drop-in for
    ops/nb_decode.decode_qspa on a supported code."""
    return _decode(L_ch, code, max_iters, False, early_stop)


def decode_layered(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                   early_stop: bool = True) -> NBDecodeResult:
    """Block-row layered FFT-QSPA: the block rows in order, the Z check rows
    of each at once; drop-in for ops/nb_decode.decode_glayered_qspa on a
    supported code, and for decode_layered_qspa where
    ``layered_is_block_rows``."""
    return _decode(L_ch, code, max_iters, True, early_stop)


def decode_flooding_global(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                           early_stop: bool = True) -> NBDecodeResult:
    """``decode_flooding`` on the global design (the yardstick)."""
    return _decode(L_ch, code, max_iters, False, early_stop, "global")


def decode_layered_global(L_ch: torch.Tensor, code: NBCode, max_iters: int,
                          early_stop: bool = True) -> NBDecodeResult:
    """``decode_layered`` on the global design (the yardstick)."""
    return _decode(L_ch, code, max_iters, True, early_stop, "global")
