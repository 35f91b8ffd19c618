"""Non-binary modulation and symbol-LLR demodulation (counterpart of
cuda_ldpc_tpu/ops/demod.py:25-132; ``nb_channel_llr_tx`` is the channel of
per-frame codewords, the random codewords of models/encoder.py).

Capability parity with the reference's encoder/demodulator pair
(myNBLDPC/src/LDPC_Encoder.cpp:6-36, myNBLDPC/src/LDPC_Decoder.cpp:132-171):

* ``bit_to_sym`` packs bits LSB-first into GF(q) symbol labels.
* ``modulate`` maps symbols (QAM) or bits (BPSK) through a constellation.
* ``llr_bpsk`` composes per-bit LLRs ``-2 Re(y)/sigma^2`` into symbol LLRs
  ``L[s] = sum of bit LLRs over the set bits of s``, added one bit at a time
  in bit order (the JAX package contracts a 0/1 matrix instead, whose order
  is XLA's).
* ``llr_qam`` computes the direct distance-difference LLR against symbol 0
  from constellation geometry.

LLR convention (the reference's): ``L[s] = log P(s)/P(0)`` so ``L[0] = 0``;
the full q-vector is carried with the 0 entry included.  Noise comes from an
explicit ``torch.Generator`` on the output's device (ops/channel.py).
"""

from __future__ import annotations

import numpy as np
import torch


def bit_to_sym(bits: np.ndarray, q_bit: int) -> np.ndarray:
    """Pack bits LSB-first into symbols: s = sum_j bit[i*q_bit+j] << j
    (myNBLDPC/src/LDPC_Encoder.cpp:6-17)."""
    bits = np.asarray(bits).reshape(-1, q_bit)
    return (bits << np.arange(q_bit)).sum(axis=1)


def sym_to_bit(syms: np.ndarray, q_bit: int) -> np.ndarray:
    """Unpack symbols into LSB-first bits, [N] -> [N*q_bit]."""
    syms = np.asarray(syms)
    return ((syms[:, None] >> np.arange(q_bit)) & 1).reshape(-1)


def modulate(labels: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Map integer labels through constellation points (complex[n_qam]).
    For BPSK, labels are bits; for QAM, labels are symbols
    (myNBLDPC/src/LDPC_Encoder.cpp:19-36)."""
    return points[np.asarray(labels)]


def _as_sigma(sigma, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(sigma, dtype=torch.float32, device=like.device)


def llr_bpsk(y_real: torch.Tensor, sigma, q: int) -> torch.Tensor:
    """BPSK symbol LLRs.  y_real: [..., N, q_bit] real channel samples (one
    per bit, symbol-major LSB-first).  Returns [..., N, q] with L[..., 0] = 0.
    ``sigma``: scalar or broadcastable (e.g. [B, 1, 1] for per-frame noise).

    Per-bit LLR is -2 y / sigma^2, symbol LLR the sum over set bits
    (myNBLDPC/src/LDPC_Decoder.cpp:139-158)."""
    q_bit = q.bit_length() - 1
    sig = _as_sigma(sigma, y_real)
    bit_llr = (-2.0 * y_real) / (sig * sig)
    sym = torch.arange(q, device=y_real.device)
    out = torch.zeros(y_real.shape[:-1] + (q,), dtype=torch.float32,
                      device=y_real.device)
    for b in range(q_bit):
        out = out + torch.where((sym >> b) & 1 == 1, bit_llr[..., b:b + 1],
                                0.0)
    return out


def llr_qam(y: torch.Tensor, sigma, points: np.ndarray) -> torch.Tensor:
    """QAM symbol LLRs from constellation geometry. y: [..., N, 2] (re, im).
    L[s] = ((2Re(y)-Re(c0)-Re(cs))(Re(cs)-Re(c0)) + (same for Im))
    / (2 sigma^2) == (|y-c0|^2 - |y-cs|^2) / (2 sigma^2)
    (myNBLDPC/src/LDPC_Decoder.cpp:162-168).  Returns [..., N, q] with
    L[..., 0] = 0."""
    re = torch.as_tensor(points.real, dtype=y.dtype, device=y.device)
    im = torch.as_tensor(points.imag, dtype=y.dtype, device=y.device)
    sig = _as_sigma(sigma, y)
    yr, yi = y[..., 0:1], y[..., 1:2]
    num = ((2.0 * yr - re[0] - re) * (re - re[0])
           + (2.0 * yi - im[0] - im) * (im - im[0]))
    return num / (2.0 * sig * sig)


def nb_channel_llr(generator: torch.Generator, tx_labels: np.ndarray,
                   points: np.ndarray, sigma, batch: int, q: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """Modulate a fixed symbol/bit label sequence, add complex AWGN drawn from
    ``generator`` (which lives on ``device``), demap to symbol LLRs.
    tx_labels: [N] symbols (QAM) or [N*q_bit] bits (BPSK).  ``sigma``:
    scalar, or a [batch] vector for per-frame noise levels.  Returns
    [batch, N, q] float32 on ``device``.

    BPSK only uses the real noise component for the LLR (the reference draws
    a complex sample per bit but demaps from .Real only,
    LDPC_Decoder.cpp:142)."""
    tx = modulate(tx_labels, points)
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    per_frame = sig.dim() == 1
    if len(points) == 2:                             # BPSK: one sample per bit
        q_bit = q.bit_length() - 1
        x = torch.as_tensor(tx.real, dtype=torch.float32, device=device)
        noise = torch.randn((batch, x.shape[0]), generator=generator,
                            dtype=torch.float32, device=device)
        y = x[None] + (sig[:, None] if per_frame else sig) * noise
        return llr_bpsk(y.reshape(batch, -1, q_bit),
                        sig[:, None, None] if per_frame else sig, q)
    x = torch.as_tensor(np.stack([tx.real, tx.imag], axis=-1),
                        dtype=torch.float32, device=device)   # [N, 2]
    noise = torch.randn((batch,) + tuple(x.shape), generator=generator,
                        dtype=torch.float32, device=device)
    y = x[None] + (sig[:, None, None] if per_frame else sig) * noise
    return llr_qam(y, sig[:, None, None] if per_frame else sig, points)


def nb_channel_llr_tx(generator: torch.Generator, tx_syms: torch.Tensor,
                      points: np.ndarray, sigma, q: int) -> torch.Tensor:
    """Per-frame transmit symbols -> modulate -> complex AWGN drawn from
    ``generator`` -> symbol LLRs (cuda_ldpc_tpu/ops/demod.py:77-106), on
    tx_syms' device.  tx_syms: [B, N] integer symbols, one codeword a frame
    (NBEncoder.encode_torch).  ``sigma``: scalar or a [B] vector.  Returns
    [B, N, q].  BPSK sends one sample per bit, LSB-first, modulated without
    a gather (x = Re(c0) + bit (Re(c1) - Re(c0))); QAM maps a symbol to a
    point.  The noise has the shape ``nb_channel_llr`` draws for the same
    modulation, so a frame of all-zero symbols sees the same samples."""
    B, N = tx_syms.shape
    dev = tx_syms.device
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    per_frame = sig.dim() == 1
    if len(points) == 2:                             # BPSK: one sample per bit
        q_bit = q.bit_length() - 1
        shifts = torch.arange(q_bit, device=dev, dtype=tx_syms.dtype)
        bits = ((tx_syms[..., None] >> shifts) & 1).reshape(B, N * q_bit)
        re0, re1 = float(points[0].real), float(points[1].real)
        x = re0 + bits.to(torch.float32) * (re1 - re0)
        noise = torch.randn((B, N * q_bit), generator=generator,
                            dtype=torch.float32, device=dev)
        y = x + (sig[:, None] if per_frame else sig) * noise
        return llr_bpsk(y.reshape(B, N, q_bit),
                        sig[:, None, None] if per_frame else sig, q)
    idx = tx_syms.long()
    re = torch.as_tensor(points.real, dtype=torch.float32, device=dev)[idx]
    im = torch.as_tensor(points.imag, dtype=torch.float32, device=dev)[idx]
    x = torch.stack([re, im], dim=-1)                # [B, N, 2]
    noise = torch.randn((B, N, 2), generator=generator, dtype=torch.float32,
                        device=dev)
    y = x + (sig[:, None, None] if per_frame else sig) * noise
    return llr_qam(y, sig[:, None, None] if per_frame else sig, points)
