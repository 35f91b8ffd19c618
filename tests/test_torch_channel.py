"""cuda_ldpc_torch.ops.channel vs the JAX package: sigma bit-identical; the
noise, which comes from another generator, by its moments."""

import numpy as np
import pytest
import torch

from cuda_ldpc_tpu.ops import channel as jax_channel
from cuda_ldpc_torch.ops import channel


@pytest.mark.parametrize("snr_type", ["ebn0", "esn0"])
def test_sigma_from_snr_matches_jax(snr_type):
    for snr in np.round(np.arange(-2.0, 13.01, 0.2), 6):
        for rate in (0.5, 5 / 6, 19200 / 38400, 14080 / 17664):
            for bps in (1.0, 2.0, 6.0):
                assert (channel.sigma_from_snr(float(snr), rate, snr_type, bps)
                        == jax_channel.sigma_from_snr(float(snr), rate,
                                                      snr_type, bps))


def test_sigma_rejects_unknown_snr_type():
    with pytest.raises(ValueError, match="snr_type"):
        channel.sigma_from_snr(1.0, 0.5, "snr")


def test_bpsk_matches_jax():
    bits = np.array([[0, 1, 1], [1, 0, 0]], dtype=np.int8)
    np.testing.assert_array_equal(channel.bpsk(torch.from_numpy(bits)).numpy(),
                                  np.asarray(jax_channel.bpsk(bits)))


def _within_5_se(x: torch.Tensor, mean: float, sigma: float):
    """Sample mean and std of x within 5 standard errors of (mean, sigma)."""
    n = x.numel()
    assert abs(x.mean().item() - mean) < 5 * sigma / n ** 0.5
    assert abs(x.std().item() - sigma) < 5 * sigma / (2 * n) ** 0.5


@pytest.mark.parametrize("sigma", [0.3, 0.8])
def test_bpsk_awgn_llr_moments(sigma):
    g = torch.Generator().manual_seed(4)
    y = channel.bpsk_awgn_llr(g, torch.zeros(24, 96), sigma, 64)
    assert y.shape == (64, 24, 96) and y.dtype == torch.float32
    _within_5_se(y, 1.0, sigma)


def test_awgn_moments_around_any_signal():
    bits = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (32, 500)))
    x = channel.bpsk(bits)
    y = channel.awgn(torch.Generator().manual_seed(9), x, 0.6)
    _within_5_se(y - x, 0.0, 0.6)


def test_noise_is_a_function_of_the_generator_seed():
    cw = torch.zeros(4, 8)
    draw = [channel.bpsk_awgn_llr(torch.Generator().manual_seed(s), cw, 0.5, 3)
            for s in (1, 1, 2)]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
