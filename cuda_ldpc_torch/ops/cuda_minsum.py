"""Wrappers of the CUDA decoders, csrc/minsum_flooding.cu (K1 flooding,
K3 its bp rule) and csrc/minsum_layered.cu (K2 layered, K3 its bp rule)
(counterpart of cuda_ldpc_tpu/ops/pallas_minsum.py).

They replace the TPU kernels ``pallas_minsum._kernel`` (flooding) and
``pallas_minsum._layered_kernel`` (layered), each with ``rule='minsum'`` or
``rule='bp'`` (``_cn_phase(rule='bp')``).  The kernels are bound by
global-memory bytes for min-sum: the c2v messages R [B, E, Z] do not fit in
shared memory (589 KB per frame on J15_L30_Z1280), so each iteration moves
them through device memory.  bp adds logf/tanhf per edge, with phi of each
message kept in registers between the check node's two passes (the row
degree's bucket is passed to the kernel).

Semantics are ops/minsum.decode_flooding's and decode_layered's, bit for bit
for min-sum, including their batch-global early stop: ``hard`` and ``ok``
come from the last iteration and ``iters`` is the batch's iteration count.
(The TPU kernels stop per 8-frame tile and report the maximum over tiles,
so they equal this only for one tile or without early stop.)  The stop flag
and the count stay on the device: a call enqueues every iteration's
launches and returns without waiting.

A CPU tensor goes to the plain version in ops/minsum.py.  A CUDA tensor goes
to the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
from cuda_ldpc_torch.ops import _build, minsum
from cuda_ldpc_torch.ops.minsum import DecodeResult

# Calls that launched each kernel, by "<rule>_<schedule>"; read and reset by
# chip_smoke.py to show that the main path went through them.
LAUNCHES = {"minsum_flooding": 0, "minsum_layered": 0, "bp_flooding": 0,
            "bp_layered": 0}

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


def _decode(schedule: str, chan: torch.Tensor, code: QCBinaryCode,
            num_iters: int, alpha: float, beta: float, check: str,
            early_stop: bool, rule: str) -> DecodeResult:
    if chan.device.type == "cpu":
        plain = {"flooding": minsum.decode_flooding,
                 "layered": minsum.decode_layered}[schedule]
        return plain(chan, code, num_iters, alpha=alpha, beta=beta,
                     check=check, early_stop=early_stop, rule=rule)
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
    B, L, Z = chan.shape
    dev = chan.device
    if B == 0 or num_iters <= 0:
        # nothing to launch: the plain version's zeros, not ok, and its
        # count (an empty batch is all ok, so it stops at once if asked to)
        iters = 0 if num_iters <= 0 or early_stop else num_iters
        return DecodeResult(
            torch.zeros((B, L, Z), dtype=torch.int8, device=dev),
            torch.zeros(B, dtype=torch.bool, device=dev),
            torch.tensor(iters, dtype=torch.int32, device=dev))
    lib = _build.load()
    max_dc = int(code.row_weights.max())
    if max_dc > lib.ldpc_max_row_degree():
        raise ValueError(f"{code.name}: row degree {max_dc} exceeds the "
                         f"kernel's {lib.ldpc_max_row_degree()}")
    E = code.num_edges
    tab = _cached_tables(code, dev)
    T = torch.empty_like(chan)
    R = torch.empty((B, E, Z), dtype=torch.float32, device=dev)
    hard = torch.empty((B, L, Z), dtype=torch.int8, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    ctl = torch.empty(3, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if schedule == "flooding":
        entry, tables = lib.ldpc_minsum_flooding, tab
    else:                          # the layered kernel needs no column CSR
        entry, tables = lib.ldpc_minsum_layered, tab[:4]
    err = entry(
        _ptr(chan), _ptr(T), _ptr(R), _ptr(hard), _ptr(ok), _ptr(ctl),
        *(_ptr(t) for t in tables), B, L, code.J, E, Z, int(num_iters),
        float(alpha), int(alpha != 1.0), float(beta), int(beta != 0.0),
        _CHECK_CODES[check], int(bool(early_stop)), _RULE_CODES[rule],
        max_dc, dev.index, ctypes.c_void_p(stream))
    name = f"{rule}_{schedule}"
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ldpc_error_string(err).decode())
    LAUNCHES[name] += 1
    return DecodeResult(hard, ok, ctl[0])


def decode_flooding(chan: torch.Tensor, code: QCBinaryCode, num_iters: int,
                    alpha: float = 1.0, beta: float = 0.0,
                    check: str = "syndrome", early_stop: bool = True,
                    rule: str = "minsum") -> DecodeResult:
    """Flooding decode of chan [B, L, Z] float32; drop-in for
    ops/minsum.decode_flooding."""
    return _decode("flooding", chan, code, num_iters, alpha, beta, check,
                   early_stop, rule)


def decode_layered(chan: torch.Tensor, code: QCBinaryCode, num_iters: int,
                   alpha: float = 1.0, beta: float = 0.0,
                   check: str = "syndrome", early_stop: bool = True,
                   rule: str = "minsum") -> DecodeResult:
    """Row-layered decode of chan [B, L, Z] float32; drop-in for
    ops/minsum.decode_layered."""
    return _decode("layered", chan, code, num_iters, alpha, beta, check,
                   early_stop, rule)
