"""Wrappers of the CUDA decoders, csrc/minsum_flooding.cu (K1 flooding,
K3 its bp rule) and csrc/minsum_layered.cu (K2 layered, K3 its bp rule)
(counterpart of cuda_ldpc_tpu/ops/pallas_minsum.py).

They replace the TPU kernels ``pallas_minsum._kernel`` (flooding) and
``pallas_minsum._layered_kernel`` (layered), each with ``rule='minsum'`` or
``rule='bp'`` (``_cn_phase(rule='bp')``), and each with its float32 or
bfloat16 storage of T and R (``msg_dtype``; pallas_minsum.py:344-352): the
bf16 forms compute in float32 and round each stored total and message to
nearest even where ops/minsum.py's plain version does (its module
docstring gives the rounding points).

Min-sum keeps each frame's state on chip for all its iterations
(csrc/onchip.cuh, built from the stream step K4's phases): the totals T and
the c2v messages compressed per check node (two magnitudes, the
first-minimum index and the sign bits: 12 bytes a check node against 4 a
message; 8 bytes, and T 2 bytes a bit, under bf16) in shared memory, on a
thread-block cluster where one block is too small (``onchip.onchip_plan``:
two blocks for J15_L30_Z1280 in either storage).  A code that no plan holds
raises the plan's ValueError; there is no other path.  bp keeps R [B, E, Z]
(and T) in device memory: phi's outputs take more than two values, so its
R has no compressed form; phi of each message is kept in registers between
the check node's two passes (the row degree's bucket is passed to the
kernel).

Semantics are ops/minsum.decode_flooding's and decode_layered's, bit for bit
for min-sum, including their batch-global early stop: ``hard`` and ``ok``
come from the iteration at which the whole batch stops and ``iters`` is the
batch's iteration count.  (The TPU kernels stop per 8-frame tile and report
the maximum over tiles, so they equal this only for one tile or without
early stop.)  The on-chip kernels keep this exact by running each frame to
its own stop, resuming the frames behind to the batch's maximum from their
saved compressed state, then going on in lockstep while a frame fails (the
protocol in csrc/onchip.cuh).  The stop flag and the count stay on the
device: a call enqueues every launch and returns without waiting.

A CPU tensor goes to the plain version in ops/minsum.py.  A CUDA tensor goes
to the kernel of its storage type, or the call raises: a bf16 call never
falls back to the plain version or to float32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
from cuda_ldpc_torch.ops import _build, minsum, onchip
from cuda_ldpc_torch.ops.minsum import DecodeResult

# Calls that launched each kernel, by "<rule>_<schedule>" and, for the
# bfloat16 storage, "<rule>_<schedule>_bf16"; read and reset by chip_smoke.py
# to show that the main path went through them.
LAUNCHES = {f"{rule}_{schedule}{suffix}": 0 for suffix in ("", "_bf16")
            for rule in ("minsum", "bp")
            for schedule in ("flooding", "layered")}

_CHECK_CODES = {"none": 0, "zero": 1, "syndrome": 2}
_RULE_CODES = {"minsum": 0, "bp": 1}


class EdgeTables(NamedTuple):
    """A code's edge structure as int32 device tensors (CSR over block rows
    and block columns; the orders are code.row_edges / code.col_edges)."""
    edge_l: torch.Tensor     # [E] block column of each edge
    edge_s: torch.Tensor     # [E] circulant shift of each edge
    row_ptr: torch.Tensor    # [J+1]
    row_edge: torch.Tensor   # [E] edges of each block row, ascending l
    col_ptr: torch.Tensor    # [L+1]
    col_edge: torch.Tensor   # [E] edges of each block column, ascending j


def edge_tables(code: QCBinaryCode, device: torch.device) -> EdgeTables:
    """Turn the code's numpy edge tables into device index tensors."""
    def csr(groups):
        ptr = np.cumsum([0] + [len(g) for g in groups])
        return ptr, np.concatenate(groups)

    row_ptr, row_edge = csr(code.row_edges)
    col_ptr, col_edge = csr(code.col_edges)
    arrays = (code.edges[:, 1], code.edges[:, 2], row_ptr, row_edge, col_ptr,
              col_edge)
    return EdgeTables(*(torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                        device=device) for a in arrays))


_tables: dict = {}


def _cached_tables(code: QCBinaryCode, device: torch.device) -> EdgeTables:
    """Edge tables go to the device once per code and device."""
    key = (code.name, code.Z, code.base.tobytes(), code.base.shape,
           str(device))
    if key not in _tables:
        _tables[key] = edge_tables(code, device)
    return _tables[key]


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_chan(chan: torch.Tensor, code: QCBinaryCode, check: str,
                rule: str):
    if chan.device.type != "cuda":
        raise ValueError(f"unsupported device {chan.device}")
    minsum.check_args(check, rule)
    if chan.dtype != torch.float32:
        raise TypeError(f"chan must be float32, got {chan.dtype}")
    if chan.dim() != 3 or tuple(chan.shape[1:]) != (code.L, code.Z):
        raise ValueError(f"chan must be [B, {code.L}, {code.Z}], got "
                         f"{tuple(chan.shape)}")
    if not chan.is_contiguous():
        raise ValueError("chan must be contiguous")


def _nothing_to_launch(chan: torch.Tensor, num_iters: int,
                       early_stop: bool) -> DecodeResult:
    """The plain version's zeros, not ok, and its count (an empty batch is
    all ok, so it stops at once if asked to)."""
    B, L, Z = chan.shape
    dev = chan.device
    iters = 0 if num_iters <= 0 or early_stop else num_iters
    return DecodeResult(
        torch.zeros((B, L, Z), dtype=torch.int8, device=dev),
        torch.zeros(B, dtype=torch.bool, device=dev),
        torch.tensor(iters, dtype=torch.int32, device=dev))


def _launch_bp(schedule: str, chan: torch.Tensor, code: QCBinaryCode,
               num_iters: int, alpha: float, beta: float, check: str,
               early_stop: bool, store: torch.dtype | None) -> DecodeResult:
    """bp with T [B, L, Z] and R [B, E, Z] of the storage type in device
    memory."""
    lib = _build.load()
    max_dc = int(code.row_weights.max())
    if max_dc > lib.ldpc_max_row_degree():
        raise ValueError(f"{code.name}: row degree {max_dc} exceeds the "
                         f"kernel's {lib.ldpc_max_row_degree()}")
    B, L, Z = chan.shape
    dev = chan.device
    E = code.num_edges
    tab = _cached_tables(code, dev)
    dtype = store or torch.float32
    T = torch.empty((B, L, Z), dtype=dtype, device=dev)
    R = torch.empty((B, E, Z), dtype=dtype, device=dev)
    hard = torch.empty((B, L, Z), dtype=torch.int8, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    ctl = torch.empty(3, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if schedule == "flooding":
        entry, tables = lib.ldpc_bp_flooding, tab
    else:                          # the layered kernel needs no column CSR
        entry, tables = lib.ldpc_bp_layered, tab[:4]
    err = entry(
        _ptr(chan), _ptr(T), _ptr(R), _ptr(hard), _ptr(ok), _ptr(ctl),
        *(_ptr(t) for t in tables), B, L, code.J, E, Z, int(num_iters),
        float(alpha), int(alpha != 1.0), float(beta), int(beta != 0.0),
        _CHECK_CODES[check], int(bool(early_stop)), max_dc,
        int(store is not None), dev.index, ctypes.c_void_p(stream))
    _raise_on(err, lib, f"bp_{schedule}")
    return DecodeResult(hard, ok, ctl[0])


def _launch_onchip(schedule: str, chan: torch.Tensor, code: QCBinaryCode,
                   num_iters: int, alpha: float, beta: float, check: str,
                   early_stop: bool, store: torch.dtype | None) -> DecodeResult:
    """Min-sum with each frame's state on chip (csrc/onchip.cuh).  With
    early stop and a check, each frame's compressed state [B, J, Z] (and,
    layered, its totals [B, L, Z]) is kept in device memory between the
    stop protocol's launches, in the storage type: (v1, v2) as 2 x 4 or
    2 x 2 bytes, the totals as stored."""
    layered = schedule == "layered"
    bf16 = store is not None
    # ValueError: no plan holds the code
    plan = onchip.cached_plan(code, layered, bf16)
    lib = _build.load()
    B, L, Z = chan.shape
    J = code.J
    dev = chan.device
    hard = torch.empty((B, L, Z), dtype=torch.int8, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    ctl = torch.empty(4, dtype=torch.int32, device=dev)
    # the stop protocol's scratch (freed after the launches are enqueued:
    # the caching allocator reuses it only behind them on this stream)
    scratch = {}
    if early_stop and check != "none":
        dtype = store or torch.float32
        scratch = {
            "kb": torch.empty(B, dtype=torch.int32, device=dev),
            "sv": torch.empty((B, J, Z, 2), dtype=dtype, device=dev),
            "sm": torch.empty((B, J, Z), device=dev, dtype=torch.int64
                              if plan.wide else torch.int32)}
        if layered:
            scratch["tsave"] = torch.empty((B, L, Z), dtype=dtype,
                                           device=dev)

    def opt(name):
        return _ptr(scratch[name]) if name in scratch else ctypes.c_void_p(0)

    entry = lib.ldpc_minsum_layered if layered else lib.ldpc_minsum_flooding
    err = entry(
        _ptr(chan), opt("tsave"), _ptr(hard), _ptr(ok), opt("kb"), opt("sv"),
        opt("sm"), _ptr(ctl),
        *(_ptr(t) for t in _cached_tables(code, dev)),
        *(_ptr(t) for t in onchip.device_tables(code, plan, dev)), B, L, J,
        code.num_edges, Z, int(num_iters), float(alpha), int(alpha != 1.0),
        float(beta), int(beta != 0.0), _CHECK_CODES[check],
        int(bool(early_stop)), plan.cluster, plan.smem_bytes, int(plan.wide),
        plan.threads, int(bf16), dev.index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, lib, f"minsum_{schedule}")
    return DecodeResult(hard, ok, ctl[0])


def _raise_on(err: int, lib, name: str):
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ldpc_error_string(err).decode())


def _decode(schedule: str, chan: torch.Tensor, code: QCBinaryCode,
            num_iters: int, alpha: float, beta: float, check: str,
            early_stop: bool, rule: str, msg_dtype) -> DecodeResult:
    if chan.device.type == "cpu":
        plain = {"flooding": minsum.decode_flooding,
                 "layered": minsum.decode_layered}[schedule]
        return plain(chan, code, num_iters, alpha=alpha, beta=beta,
                     check=check, early_stop=early_stop, rule=rule,
                     msg_dtype=msg_dtype)
    store = minsum.storage(msg_dtype)
    _check_chan(chan, code, check, rule)
    if chan.shape[0] == 0 or num_iters <= 0:
        return _nothing_to_launch(chan, num_iters, early_stop)
    launch = _launch_onchip if rule == "minsum" else _launch_bp
    res = launch(schedule, chan, code, num_iters, alpha, beta, check,
                 early_stop, store)
    LAUNCHES[f"{rule}_{schedule}" + ("_bf16" if store else "")] += 1
    return res


def decode_flooding(chan: torch.Tensor, code: QCBinaryCode, num_iters: int,
                    alpha: float = 1.0, beta: float = 0.0,
                    check: str = "syndrome", early_stop: bool = True,
                    rule: str = "minsum", msg_dtype=None) -> DecodeResult:
    """Flooding decode of chan [B, L, Z] float32, T and R stored in
    ``msg_dtype`` (None or float32, or bfloat16); drop-in for
    ops/minsum.decode_flooding."""
    return _decode("flooding", chan, code, num_iters, alpha, beta, check,
                   early_stop, rule, msg_dtype)


def decode_layered(chan: torch.Tensor, code: QCBinaryCode, num_iters: int,
                   alpha: float = 1.0, beta: float = 0.0,
                   check: str = "syndrome", early_stop: bool = True,
                   rule: str = "minsum", msg_dtype=None) -> DecodeResult:
    """Row-layered decode of chan [B, L, Z] float32, T and R stored in
    ``msg_dtype``; drop-in for ops/minsum.decode_layered."""
    return _decode("layered", chan, code, num_iters, alpha, beta, check,
                   early_stop, rule, msg_dtype)
