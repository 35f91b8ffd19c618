"""Systematic LDPC encoders, binary GF(2) and non-binary GF(q) (counterpart
of cuda_ldpc_tpu/models/encoder.py:32-229, a numpy copy with PyTorch device
encodes).

The reference ships no encoder: the binary simulator sends the all-zero
codeword (bldpc_实习/Simulation.cu:117-128) and the GF(q) one a fixed
fixture (myNBLDPC/include/codeword_test.h:1).  These encoders make random
codewords possible, and with them a true syndrome stop.

Method: one Gaussian elimination of the dense parity-check matrix into
row-reduced form.  The n - rank free columns carry the message, the rank
pivot columns the parity, parity = R @ message over GF(2) or GF(q).

Cache: ``from_code`` reads a committed ``assets/enc_<code>.npz`` (or
``enc_nb_<code>.npz``) where one exists, as the JAX package does.  Any other
code is eliminated once and cached under ``cuda_ldpc_torch/build/enc/``
(git-ignored), keyed by the code's name and a digest of its definition;
nothing is written under ``assets/``.  The bit-packed elimination takes
seconds for PON_LDPC and minutes for J15_L30_Z1280.

Device encode: one product over GF(2) a batch (``gf2_matmul``), exact by
construction: int8 operands with int32 sums (``torch._int_mm``) on a CUDA
device, float32 with TF32 and reduced-precision products turned off
elsewhere (0/1 sums stay below 2^24, so float32 holds them exactly).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import os
import pathlib

import numpy as np
import torch
import torch.nn.functional as F

from cuda_ldpc_torch.models.nb_code import NBCode
from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
from cuda_ldpc_torch.utils.registry import ASSETS_DIR

CACHE_DIR = pathlib.Path(__file__).resolve().parents[1] / "build" / "enc"


def _bit(Hw: np.ndarray, col: int) -> np.ndarray:
    return (Hw[:, col >> 6] >> np.uint64(63 - (col & 63))) & np.uint64(1)


def _gf2_eliminate(H: np.ndarray):
    """Row-reduce H over GF(2).  Returns (pivot_cols, free_cols, R) with
    R [rank, n_free]: parity[i] = sum_j R[i, j] * msg[j] mod 2."""
    m, n = H.shape
    words = (n + 63) // 64
    Hw = np.zeros((m, words * 64 // 8), dtype=np.uint8)
    Hw[:, : (n + 7) // 8] = np.packbits(H.astype(np.uint8), axis=1)
    Hw = Hw.view(np.uint64)
    Hw = Hw.byteswap()          # big-endian word bit order for _bit()
    r = 0
    pivots = []
    for col in range(n):
        if r >= m:
            break
        bits = _bit(Hw, col)
        nz = np.nonzero(bits[r:])[0]
        if nz.size == 0:
            continue
        p = r + nz[0]
        if p != r:
            Hw[[r, p]] = Hw[[p, r]]
        sel = np.nonzero(_bit(Hw, col))[0]
        sel = sel[sel != r]
        if sel.size:
            Hw[sel] ^= Hw[r]
        pivots.append(col)
        r += 1
    pivots = np.array(pivots, dtype=np.int64)
    free = np.setdiff1d(np.arange(n), pivots)
    # unpack reduced rows at the free columns
    Hb = np.unpackbits(Hw.byteswap().view(np.uint8), axis=1)[:, :n]
    R = Hb[:r][:, free]
    return pivots, free, R.astype(np.uint8)


def _gfq_eliminate(code: NBCode):
    """Row-reduce the code's H over GF(q).  Returns (pivot_cols, free_cols,
    R) with R [rank, n_free] GF coefficients: parity = R . msg."""
    mul, inv = code.mul_table, code.inv_table
    H = np.zeros((code.m_sym, code.n_sym), dtype=np.int64)
    for m in range(code.m_sym):
        for d in range(code.cn_weight[m]):
            H[m, code.cn_links[m, d]] = code.cn_gf[m, d]
    r = 0
    pivots = []
    for col in range(code.n_sym):
        if r >= code.m_sym:
            break
        nz = np.nonzero(H[r:, col])[0]
        if nz.size == 0:
            continue
        p = r + nz[0]
        if p != r:
            H[[r, p]] = H[[p, r]]
        H[r] = mul[inv[H[r, col]], H[r]]          # scale row to pivot 1
        sel = np.nonzero(H[:, col])[0]
        sel = sel[sel != r]
        if sel.size:                              # vectorized row ops
            H[sel] ^= mul[H[sel, col][:, None], H[r][None, :]]
        pivots.append(col)
        r += 1
    pivots = np.array(pivots, dtype=np.int64)
    free = np.setdiff1d(np.arange(code.n_sym), pivots)
    return pivots, free, H[:r][:, free]


def _digest(*arrays: np.ndarray) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:12]


def _cached(committed: pathlib.Path, built: pathlib.Path, cache: bool,
            eliminate, pack, unpack):
    """(pivots, free, R): from the committed file, else from the build
    cache, else eliminated (and, with ``cache``, saved to the build cache
    atomically, so concurrent processes never read a partial file)."""
    for path in ((committed, built) if cache else ()):
        if path.exists():
            with np.load(path) as d:
                return d["pivots"], d["free"], unpack(d)
    pivots, free, R = eliminate()
    if cache:
        built.parent.mkdir(parents=True, exist_ok=True)
        tmp = built.with_name(f"{built.name}.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            np.savez_compressed(f, pivots=pivots, free=free, **pack(R))
        os.replace(tmp, built)
    return pivots, free, R


@contextlib.contextmanager
def _float32_exact():
    """float32 products in float32 (no TF32, no bfloat16) for the block,
    whatever the caller set (``allow_tf32`` and the float32 matmul
    precision are views of these per-backend settings), and the caller's
    settings restored after it."""
    backends = [torch.backends.cuda.matmul, torch.backends.mkldnn.matmul]
    saved = [b.fp32_precision for b in backends]
    for b in backends:
        b.fp32_precision = "ieee"
    try:
        yield
    finally:
        for b, v in zip(backends, saved):
            b.fp32_precision = v


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _once(consts: dict, key, make):
    """consts[key], made by ``make()`` on first use (a device copy is made
    once, not at every batch)."""
    if key not in consts:
        consts[key] = make()
    return consts[key]


def gf2_matmul(bits: torch.Tensor, Rt: np.ndarray, consts: dict,
               _product: str | None = None) -> torch.Tensor:
    """bits [B, k] in {0, 1} (any dtype) times Rt [k, r] (uint8, 0/1) over
    GF(2): [B, r] int8, exactly.  On a CUDA device for B > 16 the product
    takes int8 operands and int32 sums (``torch._int_mm``, which takes more
    than 16 rows; k and r are padded to multiples of 8); otherwise float32
    with TF32 and reduced precision off.  ``_product`` ('int8' or
    'float32') overrides that choice, for the tests.  ``consts`` caches Rt
    on each device, per product; the int8 copy is stored column-major, the
    layout for which the card's int8 product takes the tensor cores' fast
    path (with it row-major, a PON_LDPC batch's encode took 4x as long on
    an H100; PERF.md).  Draw ``bits`` as int8 to spare the int8 product a
    cast."""
    B, k = bits.shape
    r = Rt.shape[1]
    dev = bits.device
    product = _product or ("int8" if dev.type == "cuda" and B > 16
                           else "float32")
    if product not in ("int8", "float32"):
        raise ValueError(f"unknown product {product!r} (expected 'int8' "
                         "or 'float32')")

    def make():
        if product == "int8":
            pad = np.zeros((_pad8(r), _pad8(k)), dtype=np.int8)
            pad[:r, :k] = Rt.T
            return torch.from_numpy(pad).to(dev).t()
        return torch.from_numpy(Rt.astype(np.float32)).to(dev)

    R = _once(consts, (str(dev), product), make)
    if product == "int8":
        if B <= 16:
            raise ValueError("the int8 product takes more than 16 rows, "
                             f"got {B}")
        a = bits.to(torch.int8)
        if R.shape[0] != k:
            a = F.pad(a, (0, R.shape[0] - k))
        return (torch._int_mm(a, R)[:, :r] & 1).to(torch.int8)
    with _float32_exact():
        sums = bits.to(torch.float32) @ R
    return torch.remainder(sums, 2.0).to(torch.int8)


def _place(first: torch.Tensor, second: torch.Tensor,
           perm: torch.Tensor) -> torch.Tensor:
    """Columns of [first | second] put into codeword order by one gather."""
    return torch.cat([first, second], dim=1).index_select(1, perm)


def _perm(free: np.ndarray, pivots: np.ndarray, consts: dict,
          dev: torch.device) -> torch.Tensor:
    """Codeword position p -> its column in [message | parity], on dev."""
    return _once(consts, ("perm", str(dev)), lambda: torch.from_numpy(
        np.argsort(np.concatenate([free, pivots]))).to(dev))


@dataclasses.dataclass
class BinaryEncoder:
    """Systematic encoder for a binary QC-LDPC code."""
    code: QCBinaryCode
    pivots: np.ndarray   # [rank] parity bit positions
    free: np.ndarray     # [k_eff] message bit positions
    R: np.ndarray        # [rank, k_eff] uint8

    def __post_init__(self):
        self._consts: dict = {}

    @property
    def k_eff(self) -> int:
        return self.free.size

    @classmethod
    def from_code(cls, code: QCBinaryCode, cache: bool = True):
        digest = _digest(code.base, np.array([code.Z]))
        pivots, free, R = _cached(
            ASSETS_DIR / f"enc_{code.name}.npz",
            CACHE_DIR / f"enc_{code.name}_{digest}.npz", cache,
            lambda: _gf2_eliminate(code.dense_H),
            lambda R: {"Rp": np.packbits(R, axis=1)},
            lambda d: np.unpackbits(d["Rp"], axis=1)[:, : d["free"].size])
        return cls(code, pivots, free, R)

    def encode(self, msg: np.ndarray) -> np.ndarray:
        """msg [..., k_eff] bits -> codeword [..., n] bits (numpy)."""
        msg = np.asarray(msg, dtype=np.uint8)
        par = (msg @ self.R.T) & 1
        cw = np.zeros(msg.shape[:-1] + (self.code.n,), dtype=np.uint8)
        cw[..., self.free] = msg
        cw[..., self.pivots] = par
        return cw

    @functools.cached_property
    def _Rt(self) -> np.ndarray:
        return np.ascontiguousarray(self.R.T)

    def encode_torch(self, msg: torch.Tensor,
                     _product: str | None = None) -> torch.Tensor:
        """Batched device encode: msg [B, k_eff] in {0, 1} (float32, or
        int8 as the sweeps draw it) ->
        codeword [B, n] int8 on msg's device; codeword index l*Z + z is
        block column l, lane z, so ``.reshape(B, L, Z)`` gives the decoder's
        layout.  ``_product``: see ``gf2_matmul``."""
        par = gf2_matmul(msg, self._Rt, self._consts, _product)
        return _place(msg.to(torch.int8), par,
                      _perm(self.free, self.pivots, self._consts,
                            msg.device))


@dataclasses.dataclass
class NBEncoder:
    """Systematic encoder for a non-binary GF(q) code."""
    code: NBCode
    pivots: np.ndarray
    free: np.ndarray
    R: np.ndarray        # [rank, k_eff] GF coefficients: parity = R . msg

    def __post_init__(self):
        self._consts: dict = {}

    @property
    def k_eff(self) -> int:
        return self.free.size

    @classmethod
    def from_code(cls, code: NBCode, cache: bool = True):
        digest = _digest(code.cn_links, code.cn_gf, code.cn_weight,
                         np.array([code.q, code.n_sym]))
        pivots, free, R = _cached(
            ASSETS_DIR / f"enc_nb_{code.name}.npz",
            CACHE_DIR / f"enc_nb_{code.name}_{digest}.npz", cache,
            lambda: _gfq_eliminate(code),
            lambda R: {"R": R.astype(np.uint8 if code.q <= 256
                                     else np.int64)},
            lambda d: d["R"].astype(np.int64))
        return cls(code, pivots, free, R)

    @functools.cached_property
    def _bit_matrix(self) -> np.ndarray:
        """GF(2^m) is an m-dimensional GF(2) vector space and multiplication
        by a constant is GF(2)-linear, so the whole parity map expands to
        one binary matrix over message bits: Rb[i*m+t, j*m+s] = bit t of
        mul(R[i,j], 2^s), and parity_bits = msg_bits @ Rb.T mod 2, one
        product a batch."""
        m = self.code.q_bit
        mul = self.code.mul_table
        rank, k_eff = self.R.shape
        Rb = np.zeros((rank * m, k_eff * m), dtype=np.uint8)
        for s in range(m):
            contrib = mul[self.R, 1 << s]                 # [rank, k_eff]
            for t in range(m):
                Rb[t::m, s::m] = (contrib >> t) & 1
        return Rb

    @functools.cached_property
    def _Rbt(self) -> np.ndarray:
        return np.ascontiguousarray(self._bit_matrix.T)

    def encode_torch(self, msg_bits: torch.Tensor,
                     _product: str | None = None) -> torch.Tensor:
        """Batched device encode from message bits: msg_bits [B, k_eff *
        q_bit] in {0, 1} (float32 or int8), LSB-first per symbol (bit s of
        free symbol j at index j*q_bit + s, the reference's BitToSym
        packing, myNBLDPC/src/LDPC_Encoder.cpp:6-17) -> codeword symbols
        [B, N] int32 on msg_bits' device.  ``_product``: see
        ``gf2_matmul``."""
        m = self.code.q_bit
        B = msg_bits.shape[0]
        dev = msg_bits.device
        par_bits = gf2_matmul(msg_bits, self._Rbt, self._consts, _product)
        w = _once(self._consts, ("weights", str(dev)), lambda: torch.tensor(
            [1 << s for s in range(m)], dtype=torch.int32, device=dev))
        msyms = (msg_bits.to(torch.int32).reshape(B, -1, m) * w).sum(-1)
        psyms = (par_bits.to(torch.int32).reshape(B, -1, m) * w).sum(-1)
        return _place(msyms.to(torch.int32), psyms.to(torch.int32),
                      _perm(self.free, self.pivots, self._consts, dev))

    def encode(self, msg: np.ndarray) -> np.ndarray:
        """msg [..., k_eff] GF symbols -> codeword [..., N] symbols.
        Parity p solves H c = 0: with reduced rows, p_i = sum R[i,j] msg_j
        (GF), since row i reads c[pivot_i] + sum_j R[i,j] c[free_j] = 0 and
        GF(2^m) addition is its own inverse."""
        msg = np.asarray(msg, dtype=np.int64)
        mul = self.code.mul_table
        par = np.zeros(msg.shape[:-1] + (self.pivots.size,), dtype=np.int64)
        for j in range(self.free.size):
            contrib = mul[self.R[:, j], msg[..., j, None]]
            par ^= contrib
        cw = np.zeros(msg.shape[:-1] + (self.code.n_sym,), dtype=np.int64)
        cw[..., self.free] = msg
        cw[..., self.pivots] = par
        return cw
