"""The port's GF(q) demodulator and plain FFT-QSPA decoders
(cuda_ldpc_torch.ops.demod, .nb_decode) against the JAX package's
``demod`` and ``nb_decode`` on the same numpy inputs, on the CPU.

Tolerances, and why: the demappers agree to rtol 1e-6 (the JAX package sums
a symbol's bit LLRs through a matrix contraction, the port one add at a
time); one CN update to rtol/atol 1e-5 (the port's butterfly transform, its
pairwise softmax sum and index gathers round otherwise than the JAX
package's Hadamard and one-hot matmuls); whole decodes give ok and iters
exactly and hard exactly on every frame whose check passed (VALIDATION.md:
94-104, the tolerance the JAX package holds its own QSPA kernels to).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu.models.nb_code import NBCode as JaxNBCode
from cuda_ldpc_tpu.ops import demod as jax_demod
from cuda_ldpc_tpu.ops import nb_decode as jax_nb
from cuda_ldpc_tpu.utils.constellations import constellation
from cuda_ldpc_torch import NBCode
from cuda_ldpc_torch.ops import channel, cuda_qspa, cuda_qspa_qc, demod
from cuda_ldpc_torch.ops import nb_decode

from test_pallas_qspa_qc import synthetic_qc_code
from test_torch_nb_host import port_code


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool, and its spinning
    threads slow the other test workers sharing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_CODES = {}


def codes(name):
    """(port code, JAX code) by registry name, or 'synthetic_qc' for the
    fully QC GF(16) code of tests/test_pallas_qspa_qc.py."""
    if name not in _CODES:
        theirs = (synthetic_qc_code() if name == "synthetic_qc"
                  else JaxNBCode.from_registry(name))
        _CODES[name] = (port_code(theirs), theirs)
    return _CODES[name]


def channel_llr(code, batch, ebn0, seed):
    """Symbol LLRs [B, N, q] of the all-zero codeword over BPSK + AWGN, from
    numpy noise (the same array goes to both packages)."""
    rng = np.random.default_rng(seed)
    sigma = channel.sigma_from_snr(ebn0, code.rate, "ebn0")
    y = 1.0 + sigma * rng.normal(size=(batch, code.n_sym, code.q_bit))
    return demod.llr_bpsk(torch.tensor(y, dtype=torch.float32), sigma,
                          code.q).numpy()


def assert_decodes_agree(ours, theirs):
    hard, ok, iters = (np.asarray(x) for x in theirs)
    assert ours.hard.dtype == torch.int32 and ours.iters.dtype == torch.int32
    np.testing.assert_array_equal(ours.ok.numpy(), ok)
    np.testing.assert_array_equal(ours.iters.numpy(), iters)
    np.testing.assert_array_equal(ours.hard.numpy()[ok], hard[ok])


# ------------------------------------------------------------------ demod

@pytest.mark.parametrize("q", [16, 64, 256])
def test_llr_bpsk_matches_jax(q):
    y = np.random.default_rng(q).normal(size=(3, 5, q.bit_length() - 1))
    y = y.astype(np.float32)
    ours = demod.llr_bpsk(torch.from_numpy(y), 0.8, q).numpy()
    theirs = np.asarray(jax_demod.llr_bpsk(jnp.asarray(y), 0.8, q))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)
    assert (ours[..., 0] == 0).all()


@pytest.mark.parametrize("n_qam", [64, 256])
def test_llr_qam_matches_jax(n_qam):
    pts = constellation(n_qam)
    y = np.random.default_rng(n_qam).normal(size=(3, 5, 2)).astype(np.float32)
    ours = demod.llr_qam(torch.from_numpy(y), 0.3, pts).numpy()
    theirs = np.asarray(jax_demod.llr_qam(jnp.asarray(y), 0.3, pts))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)


def test_bit_symbol_packing_matches_jax():
    bits = np.random.default_rng(0).integers(0, 2, 60)
    syms = demod.bit_to_sym(bits, 6)
    np.testing.assert_array_equal(syms, jax_demod.bit_to_sym(bits, 6))
    np.testing.assert_array_equal(demod.sym_to_bit(syms, 6), bits)
    pts = constellation(64)
    np.testing.assert_array_equal(demod.modulate(syms, pts),
                                  jax_demod.modulate(syms, pts))


@pytest.mark.parametrize("n_qam", [2, 64])
def test_nb_channel_llr_noise_free_and_noisy(n_qam):
    """With sigma ~ 0 the transmitted symbols win every LLR vector; the
    noise comes from the generator, so one seed gives one batch."""
    code, _ = codes("BDS.576.288.GF.64")
    tx = np.arange(code.n_sym) % code.q
    labels = demod.sym_to_bit(tx, code.q_bit) if n_qam == 2 else tx
    pts = constellation(n_qam)

    def draw(sigma, seed):
        g = torch.Generator().manual_seed(seed)
        return demod.nb_channel_llr(g, labels, pts, sigma, 4, code.q)

    L = draw(1e-3, 0)
    assert L.shape == (4, code.n_sym, code.q) and L.dtype == torch.float32
    assert (L.argmax(dim=-1) == torch.as_tensor(tx)).all()
    assert torch.equal(draw(0.7, 5), draw(0.7, 5))
    assert not torch.equal(draw(0.7, 5), draw(0.7, 6))
    per_frame = draw(torch.tensor([1e-3, 1e-3, 5.0, 5.0]), 1)
    assert (per_frame[:2].argmax(-1) == torch.as_tensor(tx)).all()


# ------------------------------------------------------------- CN update

@pytest.mark.parametrize("name", ["BDS.576.288.GF.64",
                                  "LDPC_N96_K48_GF256_d1_exp",
                                  "LDPC_N576_K288_GF64_d1_exp"])
def test_qspa_cn_core_matches_jax(name):
    """One CN update of every row on moderate messages (coefficient-0 edges
    of LDPC_N576_K288_GF64_d1_exp included)."""
    ours_code, jax_code = codes(name)
    g, jg = nb_decode.build_graph(ours_code), jax_nb.build_graph(jax_code)
    rng = np.random.default_rng(3)
    v2c = rng.normal(size=(2, g.M, g.dc, g.q)).astype(np.float32)
    v2c[..., 0] = 0.0
    ours = nb_decode._qspa_cn_core(
        torch.from_numpy(v2c), torch.as_tensor(g.cn_mask),
        torch.as_tensor(g.h_perm), g.dc, g.q).numpy()
    theirs = np.asarray(jax_nb._qspa_cn_core(
        jnp.asarray(v2c), jnp.asarray(jg.cn_mask),
        jnp.asarray(jg.h_onehot, dtype=jnp.float32),
        jnp.asarray(jax_nb._hadamard(g.q)), g.dc, g.q))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q", [16, 64, 256])
def test_butterflies_and_pairwise_sum(q):
    x = torch.from_numpy(np.random.default_rng(q).normal(
        size=(3, q)).astype(np.float32))
    H = torch.from_numpy(nb_decode._hadamard(q))
    torch.testing.assert_close(nb_decode._wht(x), x @ H, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(nb_decode._wht(nb_decode._wht(x)) / q, x,
                               rtol=1e-5, atol=1e-5)
    assert nb_decode._rtree_sum(x).shape == (3, 1)
    torch.testing.assert_close(nb_decode._rtree_sum(x)[:, 0], x.sum(-1))
    p = nb_decode._softmax(x)
    torch.testing.assert_close(p, torch.softmax(x, -1))


@pytest.mark.parametrize("name", ["BDS.576.288.GF.64", "synthetic_qc"])
def test_row_groups_match_jax(name):
    ours_code, jax_code = codes(name)
    ours = nb_decode.row_groups(ours_code.cn_links, ours_code.cn_mask)
    theirs = jax_nb.row_groups(jax_code.cn_links, jax_code.cn_mask)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- decoders

DECODE_CASES = [
    # code, method, batch, iterations, Eb/N0
    ("BDS.576.288.GF.64", "qspa", 8, 8, 1.0),
    ("BDS.576.288.GF.64", "layered_qspa", 8, 8, 1.0),
    ("BDS.576.288.GF.64", "glayered_qspa", 8, 8, 1.0),
    ("LDPC_N96_K48_GF256_d1_exp", "qspa", 8, 8, 2.5),
    ("LDPC_N96_K48_GF256_d1_exp", "layered_qspa", 8, 8, 2.5),
    ("synthetic_qc", "qspa", 3, 8, 3.0),
    ("synthetic_qc", "glayered_qspa", 3, 6, 2.5),
]


@pytest.mark.parametrize("name,method,batch,iters,ebn0", DECODE_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in DECODE_CASES])
def test_decoders_match_jax(name, method, batch, iters, ebn0):
    ours_code, jax_code = codes(name)
    L = channel_llr(ours_code, batch, ebn0, seed=batch + iters)
    ours = nb_decode.decode(torch.from_numpy(L), ours_code, method, iters)
    theirs = jax_nb.decode(jnp.asarray(L), jax_code, method, iters)
    assert_decodes_agree(ours, theirs)
    ok = ours.ok.numpy()
    assert ok.any() and ours.iters.numpy().min() < iters   # some converge


def test_zero_iterations_and_empty_batch():
    code, jax_code = codes("BDS.576.288.GF.64")
    L = channel_llr(code, 3, 2.0, seed=0)
    for method in nb_decode.QSPA_METHODS:
        res = nb_decode.decode(torch.from_numpy(L), code, method, 0)
        assert_decodes_agree(res, jax_nb.decode(jnp.asarray(L), jax_code,
                                                method, 0))
        assert not res.ok.any() and not res.hard.any() and not res.iters.any()
    res = nb_decode.decode(torch.from_numpy(L[:0]), code, "qspa", 5)
    assert res.hard.shape == (0, code.n_sym)


def test_early_stop_changes_no_output():
    """Stopped frames are frozen, so running the batch on changes
    nothing."""
    code, _ = codes("BDS.576.288.GF.64")
    L = torch.from_numpy(channel_llr(code, 4, 2.0, seed=4))
    a = nb_decode.decode_qspa(L, code, 8, early_stop=True)
    b = nb_decode.decode_qspa(L, code, 8, early_stop=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_other_methods_wait_for_their_slice():
    """The max-domain methods came with their slice: each decodes here
    (tests/test_torch_nb_maxdomain.py holds them to the JAX package); an
    unknown method still raises."""
    code, _ = codes("BDS.576.288.GF.64")
    L = torch.from_numpy(channel_llr(code, 2, 6.0, seed=2))
    for method in ("ems", "ems_full", "tmm", "layered_tmm", "glayered_tmm"):
        res = nb_decode.decode(L, code, method, 2)
        assert res.ok.all() and (res.iters == 1).all()
    with pytest.raises(ValueError, match="unknown"):
        nb_decode.decode(L, code, "bogus", 2)


@pytest.mark.parametrize("module,layered,plain", [
    (cuda_qspa, False, "decode_qspa"), (cuda_qspa, True,
                                        "decode_layered_qspa"),
    (cuda_qspa_qc, False, "decode_qspa"), (cuda_qspa_qc, True,
                                           "decode_glayered_qspa")])
def test_kernel_wrappers_take_the_plain_version_on_cpu(module, layered, plain):
    code, _ = codes("synthetic_qc" if module is cuda_qspa_qc
                    else "LDPC_N96_K48_GF256_d1_exp")
    L = torch.from_numpy(channel_llr(code, 2, 2.5, seed=1))
    before = dict(module.LAUNCHES)
    fn = module.decode_layered if layered else module.decode_flooding
    a = fn(L, code, 4)
    b = getattr(nb_decode, plain)(L, code, 4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert module.LAUNCHES == before            # counted only on launch
