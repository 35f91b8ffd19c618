"""Plain PyTorch flooding min-sum (cuda_ldpc_torch.ops.minsum) vs the JAX
package on the same numpy LLRs.  Tolerance: none — hard, ok and iters must
be exactly equal, since both add, compare and scale in the same fp32 order.
Each package decodes with its own code object, the port's built from the
JAX code's base matrix and Z.  The case against the TPU kernel in interpret
mode is in tests/test_torch_pallas_minsum.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu import QCBinaryCode
from cuda_ldpc_tpu.ops import minsum as jax_minsum
from cuda_ldpc_torch import QCBinaryCode as PortCode
from cuda_ldpc_torch.ops import minsum

# A hand-made Z=4 code (J=2, L=4): every shift, a null block in each row.
TINY = QCBinaryCode(name="tiny", base=np.array([[0, 1, 2, -1],
                                                [3, -1, 0, 1]]), Z=4)


def _code(name):
    return TINY if name == "tiny" else QCBinaryCode.from_registry(name)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool, and its spinning
    threads slow the other test workers sharing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port(code):
    """The port's code for a JAX package code."""
    return PortCode(name=code.name, base=code.base, Z=code.Z)


def _llrs(code, sigma, batch, seed):
    """All-zero codeword through BPSK + AWGN, made with numpy."""
    rng = np.random.default_rng(seed)
    return (1.0 + sigma * rng.standard_normal(
        (batch, code.L, code.Z))).astype(np.float32)


def _assert_same(a, b):
    """a: the JAX package's DecodeResult, b: the port's."""
    assert b.hard.dtype == torch.int8 and b.ok.dtype == torch.bool
    assert b.iters.dtype == torch.int32 and b.iters.dim() == 0
    np.testing.assert_array_equal(np.asarray(a.hard), b.hard.numpy())
    np.testing.assert_array_equal(np.asarray(a.ok), b.ok.numpy())
    assert int(a.iters) == int(b.iters)


# code, sigma, batch, iters, check, early stop, alpha, beta, stops early
CASES = [
    ("J4_L24_Z96", 0.45, 11, 20, "zero", True, 1.0, 0.0, True),
    ("J4_L24_Z96", 0.50, 11, 20, "syndrome", True, 0.8, 0.1, None),
    ("J4_L24_Z96", 0.55, 11, 6, "none", True, 1.0, 0.0, False),
    ("J4_L24_Z256", 0.50, 8, 6, "zero", False, 0.8, 0.1, False),
    ("J4_L24_Z256", 0.50, 8, 12, "syndrome", True, 1.0, 0.0, None),
    ("tiny", 0.50, 11, 10, "syndrome", True, 1.0, 0.0, None),
    ("tiny", 0.70, 11, 5, "zero", False, 0.8, 0.1, False),
    ("tiny", 0.50, 11, 0, "zero", True, 1.0, 0.0, False),
]


@pytest.mark.parametrize(
    "name,sigma,batch,iters,check,early,alpha,beta,stops_early", CASES,
    ids=[f"{c[0]}-{c[4]}-early{int(c[5])}-a{c[6]}b{c[7]}-it{c[3]}-B{c[2]}"
         for c in CASES])
def test_decode_flooding_matches_jax(name, sigma, batch, iters, check, early,
                                     alpha, beta, stops_early):
    code = _code(name)
    chan = _llrs(code, sigma, batch, seed=iters + batch)
    a = jax_minsum.decode_flooding(jnp.asarray(chan), code, iters,
                                   alpha=alpha, beta=beta, check=check,
                                   early_stop=early)
    b = minsum.decode_flooding(torch.from_numpy(chan), _port(code), iters,
                               alpha=alpha, beta=beta, check=check,
                               early_stop=early)
    _assert_same(a, b)
    if stops_early is not None:     # the case exercises what it claims to
        assert (int(b.iters) < iters) == stops_early


@pytest.mark.parametrize("shape", [(6, 8, 5), (3, 1, 4)])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.8, 0.1)])
def test_cn_minsum_matches_jax_bitwise(shape, alpha, beta):
    """Exact magnitude ties (first minimum wins), zeros and a degree-1 row
    (min2 is float32's max): the results must agree bit for bit."""
    rng = np.random.default_rng(3)
    vals = np.array([-2.0, -1.5, -0.5, 0.0, 0.5, 1.5, 2.0], np.float32)
    q = rng.choice(vals, size=shape).astype(np.float32)
    a = np.asarray(jax_minsum._cn_minsum(jnp.asarray(q), alpha, beta))
    b = minsum._cn_minsum(torch.from_numpy(q), alpha, beta).numpy()
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("name", ["tiny", "J4_L24_Z96"])
def test_checks_match_jax(name):
    """zero_ok / syndrome_ok on clean frames, frames with errors only in
    parity columns (zero passes, syndrome fails) and random frames."""
    code = _code(name)
    rng = np.random.default_rng(11)
    hard = np.zeros((9, code.L, code.Z), dtype=bool)
    hard[3:6, code.L - code.J:] = rng.random((3, code.J, code.Z)) < 0.2
    hard[6:] = rng.random((3, code.L, code.Z)) < 0.1
    ht = torch.from_numpy(hard)
    for ours, theirs in [(minsum.zero_ok, jax_minsum.zero_ok),
                         (minsum.syndrome_ok, jax_minsum.syndrome_ok)]:
        ref = jax.jit(functools.partial(theirs, code))(jnp.asarray(hard))
        np.testing.assert_array_equal(ours(_port(code), ht).numpy(),
                                      np.asarray(ref))
    assert minsum.zero_ok(_port(code), ht)[:3].all()
    assert minsum.syndrome_ok(_port(code), ht)[:3].all()


def test_unknown_check_raises():
    with pytest.raises(ValueError, match="check"):
        minsum.decode_flooding(torch.zeros(1, TINY.L, TINY.Z), _port(TINY),
                               2, check="parity")


@pytest.mark.parametrize("early", [True, False])
def test_empty_batch_matches_jax(early):
    """An empty batch is all ok: JAX's loop condition stops it before the
    first iteration when early stop is on."""
    chan = np.zeros((0, TINY.L, TINY.Z), np.float32)
    a = jax_minsum.decode_flooding(jnp.asarray(chan), TINY, 3, check="zero",
                                   early_stop=early)
    b = minsum.decode_flooding(torch.from_numpy(chan), _port(TINY), 3,
                               check="zero", early_stop=early)
    _assert_same(a, b)
