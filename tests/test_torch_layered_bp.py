"""Plain PyTorch layered schedule and sum-product rule
(cuda_ldpc_torch.ops.minsum.decode_layered, rule='bp') vs the JAX package on
the same numpy LLRs.

Tolerances: layered min-sum none — hard, ok and iters exactly equal, since
both packages add, compare and scale in the same fp32 order.  bp: the
check-node output within rtol 1e-5 (atol 1e-6 where phi rounds to about 0),
because XLA's CPU tanh and log are not the ones torch calls; whole decodes
have ok and iters exactly equal, and hard exactly equal on every frame whose
check passed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu import QCBinaryCode
from cuda_ldpc_tpu.ops import minsum as jax_minsum
from cuda_ldpc_tpu.ops import pallas_minsum
from cuda_ldpc_torch import QCBinaryCode as PortCode
from cuda_ldpc_torch.ops import minsum

# A hand-made Z=4 code (J=2, L=4): every shift, a null block in each row.
TINY = QCBinaryCode(name="tiny", base=np.array([[0, 1, 2, -1],
                                                [3, -1, 0, 1]]), Z=4)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool, and its spinning
    threads slow the other test workers sharing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _codes(name):
    """The JAX package's code and the port's, built from its base and Z."""
    code = TINY if name == "tiny" else QCBinaryCode.from_registry(name)
    return code, PortCode(name=code.name, base=code.base, Z=code.Z)


def _llrs(code, sigma, batch, seed, true_llr=False):
    """All-zero codeword through BPSK + AWGN, made with numpy; scaled to the
    true LLRs 2y/sigma^2 that bp needs."""
    rng = np.random.default_rng(seed)
    y = (1.0 + sigma * rng.standard_normal(
        (batch, code.L, code.Z))).astype(np.float32)
    return y * np.float32(2.0 / sigma**2) if true_llr else y


def _assert_same(a, b, rule="minsum"):
    """a: the JAX package's DecodeResult, b: the port's."""
    assert b.hard.dtype == torch.int8 and b.ok.dtype == torch.bool
    assert b.iters.dtype == torch.int32 and b.iters.dim() == 0
    np.testing.assert_array_equal(np.asarray(a.ok), b.ok.numpy())
    assert int(a.iters) == int(b.iters)
    ok = b.ok.numpy() if rule == "bp" else slice(None)
    np.testing.assert_array_equal(np.asarray(a.hard)[ok], b.hard.numpy()[ok])


# code, sigma, batch, iters, check, early stop, alpha, beta, stops early
LAYERED = [
    ("J4_L24_Z96", 0.45, 11, 20, "zero", True, 1.0, 0.0, True),
    ("J4_L24_Z96", 0.50, 11, 12, "syndrome", True, 0.8, 0.1, None),
    ("tiny", 0.55, 8, 6, "none", True, 1.0, 0.0, False),
    ("tiny", 0.50, 11, 10, "syndrome", True, 1.0, 0.0, None),
    ("tiny", 0.70, 11, 5, "zero", False, 0.8, 0.1, False),
    ("tiny", 0.50, 11, 0, "zero", True, 1.0, 0.0, False),
]


@pytest.mark.parametrize(
    "name,sigma,batch,iters,check,early,alpha,beta,stops_early", LAYERED,
    ids=[f"{c[0]}-{c[4]}-early{int(c[5])}-a{c[6]}b{c[7]}-it{c[3]}-B{c[2]}"
         for c in LAYERED])
def test_decode_layered_matches_jax(name, sigma, batch, iters, check, early,
                                    alpha, beta, stops_early):
    code, port = _codes(name)
    chan = _llrs(code, sigma, batch, seed=iters + batch)
    kw = dict(alpha=alpha, beta=beta, check=check, early_stop=early)
    a = jax_minsum.decode_layered(jnp.asarray(chan), code, iters, **kw)
    b = minsum.decode_layered(torch.from_numpy(chan), port, iters, **kw)
    _assert_same(a, b)
    if stops_early is not None:     # the case exercises what it claims to
        assert (int(b.iters) < iters) == stops_early


def test_decode_layered_matches_pallas_interpret():
    """The TPU kernel, run as its own tests run it on the CPU.  Its early
    stop is per 8-frame tile; with B = 8 there is one tile, so it equals the
    batch-global stop.  (Its total update, (T + R_new) - R_old, rounds
    otherwise than T + (R_new - R_old); on this input both agree.)"""
    code, port = _codes("J4_L24_Z256")
    chan = _llrs(code, 0.5, 8, seed=6)
    a = pallas_minsum.decode_layered(jnp.asarray(chan), code, 3,
                                     check="syndrome", early_stop=True,
                                     interpret=True)
    b = minsum.decode_layered(torch.from_numpy(chan), port, 3,
                              check="syndrome", early_stop=True)
    _assert_same(a, b)


def test_layered_converges_in_fewer_iterations_than_flooding():
    _, port = _codes("J4_L24_Z96")
    chan = torch.from_numpy(_llrs(port, 0.45, 32, seed=3))
    flood = minsum.decode_flooding(chan, port, 30, check="zero")
    lay = minsum.decode_layered(chan, port, 30, check="zero")
    assert bool(lay.ok.all()) and int(lay.iters) < int(flood.iters)


@pytest.mark.parametrize("shape", [(6, 8, 5), (3, 1, 4), (2, 23, 3)])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.8, 0.1)])
def test_cn_bp_matches_jax(shape, alpha, beta):
    """Random row-aligned true LLRs (sigma 0.7) with exact zeros and
    magnitudes that hit the clip at 34, a degree-1 row and a degree-23 row
    (PON_LDPC's largest).  atol 1e-6 besides rtol 1e-5: phi of a large
    argument is -log(tanh(x/2)) with tanh within an ulp of 1, so outputs
    below ~1e-6 are set by tanh's last bit."""
    rng = np.random.default_rng(sum(shape))
    sigma = 0.7
    q = ((1 + sigma * rng.standard_normal(shape))
         * (2 / sigma**2)).astype(np.float32)
    q.flat[::7] = 0.0
    q.flat[::11] = 40.0
    a = np.asarray(jax_minsum._cn_bp(jnp.asarray(q), alpha, beta))
    b = minsum._cn_bp(torch.from_numpy(q), alpha, beta).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


# schedule, code, sigma, batch, iters, check, early stop, alpha, beta
BP = [
    ("flooding", "J4_L24_Z96", 0.55, 12, 15, "zero", True, 1.0, 0.0),
    ("flooding", "tiny", 0.60, 11, 8, "syndrome", False, 0.8, 0.1),
    ("layered", "J4_L24_Z96", 0.55, 12, 15, "syndrome", True, 1.0, 0.0),
    ("layered", "tiny", 0.60, 11, 8, "zero", False, 0.8, 0.1),
]


@pytest.mark.parametrize(
    "schedule,name,sigma,batch,iters,check,early,alpha,beta", BP,
    ids=[f"{c[0]}-{c[1]}-{c[5]}-early{int(c[6])}-a{c[7]}b{c[8]}"
         for c in BP])
def test_bp_decode_matches_jax(schedule, name, sigma, batch, iters, check,
                               early, alpha, beta):
    code, port = _codes(name)
    chan = _llrs(code, sigma, batch, seed=batch + iters, true_llr=True)
    kw = dict(alpha=alpha, beta=beta, check=check, early_stop=early,
              rule="bp")
    a = getattr(jax_minsum, f"decode_{schedule}")(jnp.asarray(chan), code,
                                                  iters, **kw)
    b = getattr(minsum, f"decode_{schedule}")(torch.from_numpy(chan), port,
                                              iters, **kw)
    _assert_same(a, b, rule="bp")
    assert 0 < int(b.ok.sum())      # some frames pin the hard comparison


@pytest.mark.parametrize("decode", ["decode_flooding", "decode_layered"])
def test_unknown_rule_raises(decode):
    _, port = _codes("tiny")
    with pytest.raises(ValueError, match="rule"):
        getattr(minsum, decode)(torch.zeros(1, port.L, port.Z), port, 2,
                                rule="tanh")
