"""Where the on-chip min-sum kernels keep a frame's state (csrc/onchip.cuh):
the host's plan, shared by the stream step K4 (ops/cuda_minsum_stream.py)
and the batch decoders K1 and K2 (ops/cuda_minsum.py).

A frame's totals T [L, Z] f32 and its c2v messages, compressed per check
node (v1, v2 f32 and a 32-bit word of the first-minimum index and the sign
bits: 12 bytes, 16 above NARROW_DEGREE edges a row), stay in shared memory
for every iteration the kernel runs.  Under bfloat16 storage (K1 and K2
with msg_dtype bfloat16) T takes 2 bytes a bit and v1, v2 2 bytes each: 8
bytes a check node (12 when wide); chan stays float32.  Where one block's 227 KB is too
small, a thread-block cluster holds them in distributed shared memory:
``onchip_plan`` picks the smallest cluster that fits, gives each block an
even share of the block columns and rows with few edges between blocks,
and lays out each block's bytes; flooding also keeps chan on chip where it
fits.  Everything here is numpy; nothing needs a card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cuda_ldpc_torch.models.qc_binary import QCBinaryCode

# The most dynamic shared memory one H100 block can opt into (227 KB), and
# the largest portable cluster.
SMEM_PER_BLOCK = 232_448
MAX_CLUSTER = 8
# A check node's word holds the outputs' sign bits below a 6-bit
# first-minimum index: 26 edges in 32 bits, 58 in 64.
NARROW_DEGREE = 26
MAX_DEGREE = 58
_FLAG_BYTES = 32                 # the kernel's flags[MAX_CLUSTER] (int)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def header_bytes(code: QCBinaryCode) -> int:
    """The head of each block's shared memory (csrc/onchip.cuh): the
    flags; each edge's state-row and T-column address with its shift; the
    addresses of T's and chan's columns and of the rows' states; the CSR
    offsets and the blocks' column and row lists."""
    L, J, E = code.L, code.J, code.num_edges
    return _align16(_FLAG_BYTES + 16 * E + 4 * (4 * L + 3 * J + 2))


class OnChipPlan(NamedTuple):
    """Where the on-chip kernel keeps a slot's state: ``cluster`` blocks,
    each with ``smem_bytes`` of dynamic shared memory (``block_bytes`` used
    by each), each owning some of T's block columns (and chan's, when
    ``keep_chan``) and some block rows' compressed states; ``wide``: 64-bit
    check-node words; ``threads`` a block (512 or 1024).  ``table`` is the
    int32 plan the kernel reads (see csrc/onchip.cuh)."""
    cluster: int
    keep_chan: bool
    wide: bool
    smem_bytes: int
    block_bytes: tuple
    threads: int
    table: np.ndarray


def row_bytes(Z: int, wide: bool, bf16: bool = False) -> int:
    """A block row's state: (v1, v2)[Z] (8 or, bf16, 4 bytes each), then
    from the next multiple of 8 bytes the words Meta[Z] (4 or, wide, 8
    bytes each): csrc/onchip.cuh's ``meta_at``."""
    pairs = (4 if bf16 else 8) * Z
    return _align16((pairs + 7) // 8 * 8 + (8 if wide else 4) * Z)


def _layout(code: QCBinaryCode, cs: int, keep: bool, wide: bool,
            col_rank: np.ndarray, row_rank: np.ndarray,
            layered: bool, bf16: bool = False) -> OnChipPlan:
    """The plan of blocks that own the given block columns and rows: in
    each block, after the header, its T columns, its chan columns (when
    ``keep``, float32 whatever T's storage), then its rows' states.  A
    block has 1024 threads, or 512 when it runs a layered row's share of at
    most 512 lanes (PON_LDPC's 256: fewer idle warps at the barrier after
    each row)."""
    L, J, Z = code.L, code.J, code.Z
    header = header_bytes(code)
    col = _align16((2 if bf16 else 4) * Z)
    chan_col = _align16(4 * Z) if keep else 0
    row = row_bytes(Z, wide, bf16)
    col_order = np.argsort(col_rank, kind="stable")
    row_order = np.argsort(row_rank, kind="stable")
    ncols = np.bincount(col_rank, minlength=cs)
    nrows = np.bincount(row_rank, minlength=cs)
    cstart = np.concatenate([[0], np.cumsum(ncols)])
    rstart = np.concatenate([[0], np.cumsum(nrows)])
    col_pos = np.empty(L, np.int64)        # each column's place in its block
    col_pos[col_order] = np.arange(L) - cstart[col_rank[col_order]]
    col_off = header + col_pos * col
    chan_off = (header + ncols[col_rank] * col + col_pos * chan_col if keep
                else np.full(L, -1))
    cols_bytes = ncols * (col + chan_col)
    row_off = np.empty(J, np.int64)
    row_off[row_order] = (header + cols_bytes[row_rank[row_order]]
                          + (np.arange(J) - rstart[row_rank[row_order]]) * row)
    used = tuple(int(header + cols_bytes[c] + nrows[c] * row)
                 for c in range(cs))
    pad = MAX_CLUSTER - cs
    table = np.concatenate([cstart, [L] * pad, rstart, [J] * pad, col_order,
                            row_order, col_rank, col_off, chan_off, row_rank,
                            row_off])
    threads = 512 if layered and -(-Z // cs) <= 512 else 1024
    return OnChipPlan(cs, keep, wide, max(used), used, threads,
                      table.astype(np.int32))


def _cross_edges(H: np.ndarray, col_rank: np.ndarray,
                 row_rank: np.ndarray) -> int:
    return int((H & (row_rank[:, None] != col_rank[None, :])).sum())


def _partition(code: QCBinaryCode, cs: int, fits) -> tuple:
    """Block ranks of the block columns and rows for a cluster of ``cs``:
    from the contiguous split, single moves that lower the number of edges
    whose column and row lie in different blocks (their messages cross the
    cluster every pass), while ``fits(col_rank, row_rank)`` holds and each
    block keeps within a quarter of an even share of the columns and of the
    rows; then swaps of two columns or two rows between blocks, likewise.
    Returns None when not even the contiguous split fits."""
    L, J = code.L, code.J
    H = code.base >= 0
    col_rank = np.arange(L) * cs // L
    row_rank = np.arange(J) * cs // J
    if not fits(col_rank, row_rank):
        return None
    if cs == 1:
        return col_rank, row_rank

    def balanced(rank, n):
        counts = np.bincount(rank, minlength=cs)
        return (counts.min() >= np.floor(0.95 * n / cs)
                and counts.max() <= np.ceil(1.05 * n / cs))

    cut = _cross_edges(H, col_rank, row_rank)

    def better(rank, n):
        return (_cross_edges(H, col_rank, row_rank) < cut
                and balanced(rank, n) and fits(col_rank, row_rank))

    improved = True
    while improved:
        improved = False
        for rank, n in ((col_rank, L), (row_rank, J)):
            for i in range(n):
                was = rank[i]
                for c in range(cs):
                    rank[i] = c
                    if better(rank, n):
                        cut, was, improved = (
                            _cross_edges(H, col_rank, row_rank), c, True)
                rank[i] = was
            for i in range(n):
                for i2 in range(i + 1, n):
                    if rank[i] == rank[i2]:
                        continue
                    rank[i], rank[i2] = rank[i2], rank[i]
                    if better(rank, n):
                        cut = _cross_edges(H, col_rank, row_rank)
                        improved = True
                    else:
                        rank[i], rank[i2] = rank[i2], rank[i]
    return col_rank, row_rank


def onchip_plan(code: QCBinaryCode, layered: bool,
                cluster: int | None = None, bf16: bool = False) -> OnChipPlan:
    """The smallest cluster (1, 2, 4 or 8 blocks, or ``cluster``) whose
    blocks hold T [L, Z] f32 and the compressed state (12 bytes a check
    node, 16 above NARROW_DEGREE edges a row), or with ``bf16`` T in
    bfloat16 and 8 bytes a check node (12), each block owning a share of
    the block columns and block rows (``_partition``: few edges across
    blocks); flooding also keeps chan (float32) on chip where it fits
    beside them.  Raises ValueError for a code no cluster holds, whose rows
    exceed MAX_DEGREE edges, or whose Z needs more than 16 bits."""
    max_dc = int(code.row_weights.max())
    if max_dc > MAX_DEGREE:
        raise ValueError(f"{code.name}: row degree {max_dc} exceeds the "
                         f"on-chip kernels' {MAX_DEGREE}")
    if code.Z >= 1 << 16:
        raise ValueError(f"{code.name}: Z = {code.Z} exceeds the on-chip "
                         f"kernels' 16-bit shifts")
    wide = max_dc > NARROW_DEGREE
    for cs in ([cluster] if cluster else [1, 2, 4, MAX_CLUSTER]):
        if not 1 <= cs <= MAX_CLUSTER:
            raise ValueError(f"cluster must be 1-{MAX_CLUSTER}, got {cs}")
        for keep in ((False,) if layered else (True, False)):
            def fits(col_rank, row_rank):
                plan = _layout(code, cs, keep, wide, col_rank, row_rank,
                               layered, bf16)
                return plan.smem_bytes <= SMEM_PER_BLOCK

            ranks = _partition(code, cs, fits)
            if ranks is not None:
                return _layout(code, cs, keep, wide, *ranks, layered, bf16)
    raise ValueError(f"{code.name}: T and the compressed state need more "
                     f"than {MAX_CLUSTER} x {SMEM_PER_BLOCK} bytes of shared "
                     f"memory")


def edge_positions(code: QCBinaryCode) -> tuple[np.ndarray, np.ndarray]:
    """Each edge's block row and its position in code.row_edges[row]."""
    edge_row = np.zeros(code.num_edges, np.int32)
    edge_pos = np.zeros(code.num_edges, np.int32)
    for j, edges in enumerate(code.row_edges):
        edge_row[edges] = j
        edge_pos[edges] = np.arange(len(edges))
    return edge_row, edge_pos


_plans: dict = {}
_device_tables: dict = {}


def _code_key(code: QCBinaryCode) -> tuple:
    return (code.name, code.Z, code.base.tobytes(), code.base.shape)


def cached_plan(code: QCBinaryCode, layered: bool,
                bf16: bool = False) -> OnChipPlan:
    """``onchip_plan(code, layered, bf16=bf16)``, computed once per code,
    schedule and storage."""
    key = (*_code_key(code), layered, bf16)
    if key not in _plans:
        _plans[key] = onchip_plan(code, layered, bf16=bf16)
    return _plans[key]


def device_tables(code: QCBinaryCode, plan: OnChipPlan, dev: torch.device):
    """edge_row, edge_pos and the plan table on the device, once each."""
    key = (*_code_key(code), plan.table.tobytes(), str(dev))
    if key not in _device_tables:
        _device_tables[key] = tuple(
            torch.as_tensor(a, device=dev)
            for a in (*edge_positions(code), plan.table))
    return _device_tables[key]
