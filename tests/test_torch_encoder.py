"""The port's encoders (cuda_ldpc_torch.models.encoder), its random-codeword
GF(q) channel (ops/demod.nb_channel_llr_tx) and a random-codeword binary
batch, on the CPU, held against the JAX package.

Tolerances: none for the eliminations, the codewords, the decisions and
the counters (integer arithmetic, and min-sum adds and compares in the same
fp32 order in both packages); the symbol LLRs within 1e-6 relative (both
sum at most q_bit per-bit LLRs of one sample, in bit order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu.models import encoder as jax_encoder
from cuda_ldpc_tpu.models.nb_code import NBCode as JaxNBCode
from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode as JaxCode
from cuda_ldpc_tpu.ops import demod as jax_demod
from cuda_ldpc_tpu.ops import minsum as jax_minsum
from cuda_ldpc_torch import NBCode, QCBinaryCode, sim
from cuda_ldpc_torch import config as cfg
from cuda_ldpc_torch.models import encoder
from cuda_ldpc_torch.ops import _build, channel, demod, minsum
from cuda_ldpc_torch.utils import registry
from cuda_ldpc_torch.utils.constellations import constellation

BINARY = ["J4_L24_Z96", "J8_L24_Z96"]
NB = ["BDS.576.288.GF.64", "LDPC_N96_K48_GF256_d1_exp"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", BINARY)
def test_gf2_elimination_matches_jax(name):
    ours = encoder._gf2_eliminate(QCBinaryCode.from_registry(name).dense_H)
    theirs = jax_encoder._gf2_eliminate(JaxCode.from_registry(name).dense_H)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", NB)
def test_gfq_elimination_matches_jax(name):
    ours = encoder.NBEncoder.from_code(NBCode.from_registry(name),
                                       cache=False)
    theirs = jax_encoder.NBEncoder.from_code(JaxNBCode.from_registry(name),
                                             cache=False)
    for f in ("pivots", "free", "R"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    np.testing.assert_array_equal(ours._bit_matrix, theirs._bit_matrix)


@pytest.mark.parametrize("product", ["float32", "int8"])
@pytest.mark.parametrize("name", BINARY)
def test_binary_codewords_match_jax(name, product):
    """numpy and device encodes against the JAX package's encode of the
    same messages; every codeword meets H c = 0."""
    code = QCBinaryCode.from_registry(name)
    ours = encoder.BinaryEncoder.from_code(code)
    theirs = jax_encoder.BinaryEncoder.from_code(JaxCode.from_registry(name),
                                                 cache=False)
    msg = np.random.default_rng(3).integers(0, 2, (24, ours.k_eff))
    want = theirs.encode(msg)
    np.testing.assert_array_equal(ours.encode(msg), want)
    got = ours.encode_torch(torch.tensor(msg, dtype=torch.float32),
                            _product=product)
    assert got.dtype == torch.int8 and got.shape == (24, code.n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not ((want.astype(np.int64) @ code.dense_H.T) & 1).any()
    # codeword index l*Z + z is block column l, lane z
    np.testing.assert_array_equal(got.reshape(24, code.L, code.Z)[:, 1, 2],
                                  want[:, code.Z + 2])


@pytest.mark.parametrize("product", ["float32", "int8"])
@pytest.mark.parametrize("name", NB)
def test_nb_codewords_match_jax(name, product):
    code = NBCode.from_registry(name)
    ours = encoder.NBEncoder.from_code(code)
    theirs = jax_encoder.NBEncoder.from_code(JaxNBCode.from_registry(name),
                                             cache=False)
    msg = np.random.default_rng(4).integers(0, code.q, (20, ours.k_eff))
    want = theirs.encode(msg)
    np.testing.assert_array_equal(ours.encode(msg), want)
    bits = ((msg[..., None] >> np.arange(code.q_bit)) & 1).reshape(20, -1)
    got = ours.encode_torch(torch.tensor(bits, dtype=torch.float32),
                            _product=product)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not any(code.syndrome(c).any() for c in want)


def test_float32_product_is_exact_whatever_the_caller_set():
    """The float32 product turns reduced precision off for itself and
    restores the caller's setting; the int8 product refuses 16 rows or
    fewer (torch._int_mm's limit); an unknown product raises."""
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    enc = encoder.BinaryEncoder.from_code(code)
    msg = np.random.default_rng(5).integers(0, 2, (4, enc.k_eff))
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got = enc.encode_torch(torch.tensor(msg, dtype=torch.float32))
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)
    np.testing.assert_array_equal(got.numpy(), enc.encode(msg))
    with pytest.raises(ValueError, match="16 rows"):
        enc.encode_torch(torch.tensor(msg, dtype=torch.float32),
                         _product="int8")
    with pytest.raises(ValueError, match="unknown product"):
        enc.encode_torch(torch.tensor(msg, dtype=torch.float32),
                         _product="bf16")


def test_committed_caches_are_read(monkeypatch):
    """J4, J8 and BDS come from assets/, with no elimination."""
    def refuse(*a):
        raise AssertionError("eliminated a code with a committed cache")

    monkeypatch.setattr(encoder, "_gf2_eliminate", refuse)
    monkeypatch.setattr(encoder, "_gfq_eliminate", refuse)
    for name in BINARY:
        enc = encoder.BinaryEncoder.from_code(QCBinaryCode.from_registry(name))
        with np.load(registry.ASSETS_DIR / f"enc_{name}.npz") as d:
            np.testing.assert_array_equal(enc.pivots, d["pivots"])
        assert enc.R.shape == (enc.pivots.size, enc.k_eff)
    enc = encoder.NBEncoder.from_code(NBCode.from_registry(NB[0]))
    assert enc.R.shape == (48, 48)


def test_uncached_codes_cache_under_build(tmp_path, monkeypatch):
    """A code without a committed cache is eliminated once and cached under
    the package's git-ignored build directory (redirected here), and
    nothing is written under assets/."""
    assert encoder.CACHE_DIR == _build.BUILD_DIR / "enc"
    monkeypatch.setattr(encoder, "CACHE_DIR", tmp_path / "enc")
    assets = sorted(p.name for p in registry.ASSETS_DIR.iterdir())
    bcode = QCBinaryCode.from_registry("J6_L24_Z96")
    ncode = NBCode.from_registry(NB[1])
    first = (encoder.BinaryEncoder.from_code(bcode),
             encoder.NBEncoder.from_code(ncode))
    cached = sorted(p.name for p in (tmp_path / "enc").iterdir())
    assert len(cached) == 2 and cached[0].startswith("enc_J6_L24_Z96_")
    assert cached[1].startswith(f"enc_nb_{NB[1]}_")
    assert sorted(p.name for p in registry.ASSETS_DIR.iterdir()) == assets

    def refuse(*a):
        raise AssertionError("eliminated a cached code")

    monkeypatch.setattr(encoder, "_gf2_eliminate", refuse)
    monkeypatch.setattr(encoder, "_gfq_eliminate", refuse)
    again = (encoder.BinaryEncoder.from_code(bcode),
             encoder.NBEncoder.from_code(ncode))
    for a, b in zip(first, again):
        for f in ("pivots", "free", "R"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("per_frame", [False, True])
@pytest.mark.parametrize("n_qam,name", [(2, NB[0]), (64, NB[0])])
def test_nb_channel_llr_tx_matches_jax(n_qam, name, per_frame):
    """The port's channel against the JAX package's demappers on y built
    from the same noise, drawn once with a seeded generator."""
    code = NBCode.from_registry(name)
    B, q_bit = 6, code.q_bit
    pts = constellation(n_qam)
    tx = torch.from_numpy(np.random.default_rng(6).integers(
        0, code.q, (B, code.n_sym)).astype(np.int32))
    sigma = (torch.linspace(0.5, 0.9, B) if per_frame else 0.7)
    L = demod.nb_channel_llr_tx(torch.Generator().manual_seed(9), tx, pts,
                                sigma, code.q)
    assert L.shape == (B, code.n_sym, code.q)
    sig = np.asarray(sigma, np.float32)
    syms = tx.numpy()
    if n_qam == 2:
        noise = torch.randn((B, code.n_sym * q_bit),
                            generator=torch.Generator().manual_seed(9))
        bits = (syms[..., None] >> np.arange(q_bit)) & 1
        x = pts[bits].real.reshape(B, -1).astype(np.float32)
        y = x + (sig[:, None] if per_frame else sig) * noise.numpy()
        want = jax_demod.llr_bpsk(
            jnp.asarray(y.reshape(B, code.n_sym, q_bit)),
            jnp.asarray(sig[:, None, None] if per_frame else sig), code.q)
    else:
        noise = torch.randn((B, code.n_sym, 2),
                            generator=torch.Generator().manual_seed(9))
        x = np.stack([pts[syms].real, pts[syms].imag], -1).astype(np.float32)
        y = x + (sig[:, None, None] if per_frame else sig) * noise.numpy()
        want = jax_demod.llr_qam(
            jnp.asarray(y), jnp.asarray(sig[:, None, None] if per_frame
                                        else sig), pts)
    np.testing.assert_allclose(L.numpy(), np.asarray(want), rtol=1e-6)
    # the all-zero word through it sees nb_channel_llr's samples
    zero = torch.zeros((B, code.n_sym), dtype=torch.int32)
    labels = np.zeros(code.bit_length if n_qam == 2 else code.n_sym, int)
    torch.testing.assert_close(
        demod.nb_channel_llr_tx(torch.Generator().manual_seed(9), zero, pts,
                                sigma, code.q),
        demod.nb_channel_llr(torch.Generator().manual_seed(9), labels, pts,
                             sigma, B, code.q), rtol=0, atol=0)


def test_random_codeword_batch_matches_jax_minsum():
    """A J4 batch of random codewords (the sweep's own source) decoded by
    the port's plain flooding min-sum with the syndrome check, against the
    JAX package's decode_flooding on the same channel values: hard, ok and
    iters exactly equal; the port's counters equal the JAX formula of
    cuda_ldpc_tpu/sim.py:427-439 recomputed in numpy."""
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    scfg = cfg.BinarySimConfig(code=code.name, batch_per_device=24,
                               tx="random", decoder=cfg.BinaryDecoderConfig(
                                   max_iters=12, check="syndrome"))
    fresh = sim._binary_source(code, scfg, 24, torch.device("cpu"))
    sigma = channel.sigma_from_snr(3.2, code.rate, "ebn0")
    chan, cw = fresh(torch.Generator().manual_seed(4), sigma)
    assert cw.shape == (24, code.L, code.Z) and cw.any()
    assert not ((cw.reshape(24, -1).numpy().astype(np.int64)
                 @ code.dense_H.T) & 1).any()
    ours = minsum.decode_flooding(chan, code, 12, check="syndrome")
    theirs = jax_minsum.decode_flooding(jnp.asarray(chan.numpy()),
                                        JaxCode.from_registry(code.name), 12,
                                        check="syndrome")
    hard = np.asarray(theirs.hard)
    np.testing.assert_array_equal(ours.hard.numpy(), hard)
    np.testing.assert_array_equal(ours.ok.numpy(), np.asarray(theirs.ok))
    assert int(ours.iters) == int(theirs.iters)
    ok = np.asarray(theirs.ok)
    mc = code.L - code.J
    errbits = (hard[:, :mc] != cw.numpy()[:, :mc]).sum(axis=(1, 2))
    has_err = errbits > 0
    want = [errbits.sum(), (has_err | ~ok).sum(), (has_err & ok).sum(),
            (~has_err & ~ok).sum(), int(theirs.iters)]
    got = sim._counters(ours, mc, cw).tolist()
    assert got == [int(x) for x in want]
    assert 0 < want[1] < 24           # some frames fail, some pass
    # the decisions differ from the all-zero word: counting against it
    # would be wrong
    assert sim._counters(ours, mc).tolist()[0] > 10 * max(want[0], 1)
