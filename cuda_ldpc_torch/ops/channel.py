"""Source / modulation / AWGN channel ops (counterpart of
cuda_ldpc_tpu/ops/channel.py:22-56).

Sigma formulas match the reference exactly:
* Eb/N0: sqrt(0.5 / (bits_per_sym * rate * 10^(SNR/10)))
* Es/N0: sqrt(0.5 / (bits_per_sym * 10^(SNR/10)))

Noise comes from an explicit ``torch.Generator`` that lives on the tensor's
device.  It is Philox on a CUDA device and Mersenne Twister on the CPU, so
it never reproduces the JAX package's threefry bits: sweeps on this channel
agree with the JAX package statistically, and the reference-LCG channel
(sim.py) is the one that gives both packages the same noise.
"""

from __future__ import annotations

import numpy as np
import torch


def sigma_from_snr(snr_db: float, rate: float, snr_type: str = "ebn0",
                   bits_per_sym: float = 1.0) -> float:
    """Noise sigma per real dimension for a given SNR point (host numpy, the
    same arithmetic as the JAX package, so bit-identical)."""
    es = 10.0 ** (snr_db / 10.0)
    if snr_type == "ebn0":
        return float(np.sqrt(0.5 / (bits_per_sym * rate * es)))
    if snr_type == "esn0":
        return float(np.sqrt(0.5 / (bits_per_sym * es)))
    raise ValueError(f"unknown snr_type {snr_type!r}")


def bpsk(bits: torch.Tensor) -> torch.Tensor:
    """BPSK map y = 1 - 2c (float32)."""
    return 1.0 - 2.0 * bits.to(torch.float32)


def awgn(generator: torch.Generator, x: torch.Tensor,
         sigma: float) -> torch.Tensor:
    """Real AWGN: y = x + sigma * n, with n drawn from ``generator``."""
    noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                        device=x.device)
    return noise.mul_(sigma).add_(x)


def bpsk_awgn_llr(generator: torch.Generator, codeword: torch.Tensor,
                  sigma: float | torch.Tensor, batch: int) -> torch.Tensor:
    """All-in-one binary channel for an [L, Z] codeword -> [batch, L, Z]
    samples on the codeword's device.  ``sigma``: a float, or a [batch]
    tensor of per-frame noise levels (the packed engines).

    The binary reference feeds raw channel samples to the decoder (its 'LLR'
    is y itself, a positive scaling of 2y/sigma^2 — min-sum is scale
    invariant).  The noise tensor is updated in place, so the batch costs one
    [batch, L, Z] allocation."""
    x = bpsk(codeword)
    noise = torch.randn((batch,) + tuple(codeword.shape), generator=generator,
                        dtype=torch.float32, device=codeword.device)
    if isinstance(sigma, torch.Tensor):
        sigma = sigma.to(torch.float32).reshape((-1,) + (1,) * codeword.dim())
    return noise.mul_(sigma).add_(x)


def bpsk_awgn_frames(generator: torch.Generator, codewords: torch.Tensor,
                     sigma: float | torch.Tensor) -> torch.Tensor:
    """The binary channel of per-frame codewords [B, L, Z] (0/1, one
    codeword a frame): y = 1 - 2c + sigma * n, with n drawn from
    ``generator`` in the shape ``bpsk_awgn_llr`` draws for the same batch.
    ``sigma``: a float or a [B] tensor."""
    noise = torch.randn(codewords.shape, generator=generator,
                        dtype=torch.float32, device=codewords.device)
    if isinstance(sigma, torch.Tensor):
        sigma = sigma.to(torch.float32).reshape(
            (-1,) + (1,) * (codewords.dim() - 1))
    return noise.mul_(sigma).add_(bpsk(codewords))
