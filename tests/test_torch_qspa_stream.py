"""The GF(q) stream step's plain PyTorch version
(cuda_ldpc_torch.ops.qspa_stream, K7's reference) against the JAX package
on the same numpy-made symbol LLRs: the JAX kernel
cuda_ldpc_tpu/ops/pallas_qspa_stream.stream_step in interpret mode, and the
stream step's semantics on the JAX package's jnp core (the loop of
tests/test_qspa_stream.py, to which the JAX tests hold that kernel).

Tolerances: t, done and okf exactly; hard exactly on the slots whose check
passed (the QSPA tolerance of VALIDATION.md:94-104), and here on every slot;
C zeroed on the finished slots.  The messages themselves are compared as
probabilities (softmax over the q symbols), within 1e-4: the TPU kernel
takes the transform and the permutations through matmuls, the port through
butterflies and gathers, and the log of the pmf magnifies the different
roundings in the tail, where a log-domain message can differ by 0.1 at a
probability below 1e-20 (measured: 2.8e-5 in probability after four passes
on BDS.576.288.GF.64)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu.models.nb_code import NBCode as JaxNBCode
from cuda_ldpc_tpu.ops import nb_decode as jax_nb
from cuda_ldpc_tpu.ops import pallas_qspa, pallas_qspa_stream
from cuda_ldpc_torch.models.nb_code import NBCode
from cuda_ldpc_torch.ops import demod, qspa_stream


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _codes(name):
    return JaxNBCode.from_registry(name), NBCode.from_registry(name)


def _llr(code, B, sigma, seed):
    """BPSK symbol LLRs of the all-zero codeword, numpy noise."""
    rng = np.random.default_rng(seed)
    y = 1.0 + sigma * rng.normal(size=(B, code.n_sym, code.q_bit))
    return demod.llr_bpsk(torch.tensor(y, dtype=torch.float32), sigma,
                          code.q).numpy()


def _port(code, L, k, max_it, layered):
    B = L.shape[0]
    z = torch.zeros(B, dtype=torch.int32)
    out = qspa_stream.stream_step(
        torch.from_numpy(L.copy()),
        torch.zeros(B, int(code.cn_mask.sum()), code.q), z, z.clone(),
        z.clone(), code, k, max_it, layered=layered)
    return [x.numpy() for x in out]


def _softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


@pytest.mark.parametrize("method", ["layered_qspa"])
def test_stream_step_matches_the_jax_kernel(method):
    """The JAX kernel itself, in interpret mode (one case: about 10 s a
    call here; the rest is held to the jnp core loop below, to which the
    JAX tests hold the kernel)."""
    jc, pc = _codes("LDPC_N96_K48_GF256_d1_exp")
    B, k, max_it = 8, 4, 6
    layered = method == "layered_qspa"
    L = _llr(pc, B, 0.85, seed=3)
    plan = pallas_qspa.make_plan(jc)
    qp = pallas_qspa_stream._lane_pad(jc.q)
    z = jnp.zeros((B, 128), jnp.int32)
    out = pallas_qspa_stream.stream_step(
        pallas_qspa_stream.pack_chan(jnp.asarray(L), jc),
        jnp.zeros((plan.E, B, qp), jnp.float32), z, z, z, jc, k=k,
        max_iters=max_it, layered=layered, tile_b=8, interpret=True)
    jchan, jC, jhard_oh, jt, jd, jo = (np.asarray(x) for x in out)
    # the JAX kernel's lanes hold symbols in discrete-log order (sym)
    sym = (np.asarray(plan.sym) if plan.scheme == "logrot"
           else np.arange(jc.q))
    jhard = sym[np.argmax(jhard_oh, axis=2)].T
    pchan, pC, phard, pt, pd, po = _port(pc, L, k, max_it, layered)
    for a, b in ((jt[:, 0], pt), (jd[:, 0], pd), (jo[:, 0], po),
                 (jhard, phard)):
        np.testing.assert_array_equal(a, b)
    assert 0 < pd.sum() < B and (pC[pd == 1] == 0).all()
    jC = jC[:, :, :jc.q].transpose(1, 0, 2)                  # [B, E, lane]
    np.testing.assert_allclose(_softmax(jC), _softmax(pC[:, :, sym]),
                               rtol=0, atol=1e-4)
    if layered:
        jchan = jchan[:, :, :jc.q].transpose(1, 0, 2)
        np.testing.assert_allclose(_softmax(jchan), _softmax(pchan[:, :, sym]),
                                   rtol=0, atol=1e-4)


def _jnp_loop(jc, L, k, max_it, method):
    """tests/test_qspa_stream.py's loop over the JAX nb_decode.build_core."""
    B = L.shape[0]
    core = jax_nb.build_core(jc, method)
    decide, step = jax.jit(core.decide), jax.jit(core.step)
    syndrome = jax.jit(lambda h: jax_nb._syndrome_ok(core.g, h))
    carry = core.init(jnp.asarray(L))
    t = np.zeros(B, np.int32)
    done = np.zeros(B, bool)
    okf = np.zeros(B, bool)
    hard = np.zeros((B, jc.n_sym), np.int32)
    for _ in range(k):
        hard_new, llr = decide(carry)
        hard = np.where(done[:, None], hard, np.asarray(hard_new))
        ok = np.asarray(syndrome(jnp.asarray(hard)))
        fin = ~done & (ok | (t >= max_it))
        okf = np.where(fin, ok, okf)
        done |= fin
        t = t + ~done
        if done.all():
            break
        carry = step(carry, llr, jnp.asarray(~done))
    return hard, t, done, okf


@pytest.mark.parametrize("name,method,sigma", [
    ("BDS.576.288.GF.64", "qspa", 0.9),
    ("BDS.576.288.GF.64", "layered_qspa", 0.9),
    ("LDPC_N96_K48_GF256_d1_exp", "qspa", 0.85)])
def test_stream_step_matches_the_jax_core_loop(name, method, sigma):
    """The JAX test's cases (test_qspa_stream.py:71-91) on the semantics the
    JAX kernel is held to (its interpret mode takes about a minute a call
    on BDS here)."""
    jc, pc = _codes(name)
    B, k, max_it = 8, 4, 6
    L = _llr(pc, B, sigma, seed=3)
    jhard, jt, jd, jo = _jnp_loop(jc, L, k, max_it, method)
    _, _, phard, pt, pd, po = _port(pc, L, k, max_it,
                                    method == "layered_qspa")
    np.testing.assert_array_equal(jt, pt)
    np.testing.assert_array_equal(jd, pd.astype(bool))
    np.testing.assert_array_equal(jo, po.astype(bool))
    np.testing.assert_array_equal(jhard[jo], phard[jo])


@pytest.mark.parametrize("layered", [False, True])
def test_two_calls_equal_one_call(layered):
    """Two k=2 calls == one k=4 call on the slots alive into the second
    call (a finished slot's C left zeroed; the engine refills it)."""
    _, pc = _codes("BDS.576.288.GF.64")
    B, max_it = 8, 6
    L = torch.from_numpy(_llr(pc, B, 0.95, seed=11))
    E = int(pc.cn_mask.sum())
    z = torch.zeros(B, dtype=torch.int32)

    def state():
        return [L.clone(), torch.zeros(B, E, pc.q), z.clone(), z.clone(),
                z.clone()]

    one = qspa_stream.stream_step(*state(), pc, 4, max_it, layered=layered)
    st, alive = state(), None
    for _ in range(2):
        out = qspa_stream.stream_step(*st, pc, 2, max_it, layered=layered)
        st = [x for i, x in enumerate(out) if i != 2]
        alive = ~out[4].bool() if alive is None else alive
    for i in (0, 1, 3, 4, 5):             # chan, C, t, done, okf
        assert torch.equal(one[i], out[i])
    assert torch.equal(one[2][alive], out[2][alive])
    assert alive.any()
