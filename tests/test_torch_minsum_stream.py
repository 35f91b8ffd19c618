"""The binary stream step's plain PyTorch version
(cuda_ldpc_torch.ops.minsum_stream, K4's reference) and the core it drives
(cuda_ldpc_torch.ops.minsum.build_core) against the JAX package on the same
numpy LLRs: the JAX kernel cuda_ldpc_tpu/ops/pallas_minsum_stream.stream_step
in interpret mode, and cuda_ldpc_tpu/ops/minsum.build_core.

Tolerances.  Min-sum: none on t, done, okf, hard, R (zeroed on finished
slots) and the totals, against the jnp core; against the TPU kernel the
layered totals within 1e-5, since the kernel rounds its update as
(T + R_new) - R_old where the jnp function and the port add
T + (R_new - R_old).  bp: t, done, okf and hard exactly, the
messages and totals within rtol 1e-5 (XLA's CPU tanh and log are not the
ones torch calls; the tolerance ROADMAP.md:52-54 sets)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode as JaxCode
from cuda_ldpc_tpu.ops import minsum as jax_minsum
from cuda_ldpc_tpu.ops import pallas_minsum_stream
from cuda_ldpc_tpu.ops.pallas_minsum import _lane_pad
from cuda_ldpc_torch import QCBinaryCode
from cuda_ldpc_torch.ops import minsum, minsum_stream


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def codes():
    jc = JaxCode.from_registry("J4_L24_Z96")
    return jc, QCBinaryCode(name=jc.name, base=jc.base, Z=jc.Z)


def _chan(code, B, sigma, seed, rule):
    rng = np.random.default_rng(seed)
    y = (1.0 + sigma * rng.normal(size=(B, code.L, code.Z))).astype(np.float32)
    return y * np.float32(2.0 / sigma**2) if rule == "bp" else y


def _close(a, b, rule):
    if rule == "bp":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rule", ["minsum", "bp"])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_build_core_matches_jax(codes, schedule, rule):
    """decide and step, with a per-frame freeze, for four iterations."""
    jc, pc = codes
    chan = _chan(jc, 6, 0.7, seed=5, rule=rule)
    kw = dict(rule=rule, schedule=schedule, alpha=0.8, beta=0.05)
    jcore, pcore = jax_minsum.build_core(jc, **kw), minsum.build_core(pc, **kw)
    jcarry, pcarry = jcore.init(jnp.asarray(chan)), pcore.init(
        torch.from_numpy(chan))
    for it in range(4):
        jhard, jtot = jcore.decide(jcarry)
        phard, ptot = pcore.decide(pcarry)
        np.testing.assert_array_equal(np.asarray(jhard), phard.numpy())
        _close(np.asarray(jtot), ptot.numpy(), rule)
        cont = np.arange(6) % (it + 2) != 0          # a different freeze each
        jcarry = jcore.step(jcarry, jtot, jnp.asarray(cont))
        pcarry = pcore.step(pcarry, ptot, torch.from_numpy(cont))
        for a, b in zip(jcarry, pcarry):
            _close(np.asarray(a), b.numpy(), rule)


def _jax_step(jc, chan, k, max_it, check, rule, layered):
    """The JAX kernel in interpret mode on fresh slots; outputs in the
    port's layout."""
    B = chan.shape[0]
    Zp = _lane_pad(jc.Z)
    cm = np.zeros((jc.L, B, Zp), np.float32)
    cm[:, :, :jc.Z] = chan.transpose(1, 0, 2)
    z = jnp.zeros((B, 128), jnp.int32)
    out = pallas_minsum_stream.stream_step(
        jnp.asarray(cm), jnp.zeros((jc.num_edges, B, Zp), jnp.float32), z, z,
        z, jc, k=k, max_iters=max_it, check=check, rule=rule,
        layered=layered, interpret=True)
    c2, R2, hard, t2, d2, o2 = (np.asarray(x) for x in out)
    lz = lambda x: x[:, :, :jc.Z].transpose(1, 0, 2)       # noqa: E731
    return lz(c2), lz(R2), lz(hard), t2[:, 0], d2[:, 0], o2[:, 0]


def _port_step(pc, chan, k, max_it, check, rule, layered):
    B = chan.shape[0]
    z = torch.zeros(B, dtype=torch.int32)
    out = minsum_stream.stream_step(
        torch.from_numpy(chan.copy()),
        torch.zeros(B, pc.num_edges, pc.Z), z, z.clone(), z.clone(), pc, k,
        max_it, check=check, rule=rule, layered=layered)
    return [x.numpy() for x in out]


def _jnp_loop(jc, chan, k, max_it, check, rule, schedule):
    """The stream step's semantics on the JAX package's jnp core (the loop
    of tests/test_minsum_stream.py, to which the JAX tests hold the JAX
    kernel), returning what the port's step returns."""
    B = chan.shape[0]
    core = jax_minsum.build_core(jc, rule=rule, schedule=schedule)
    carry = core.init(jnp.asarray(chan))
    t = np.zeros(B, np.int32)
    done = np.zeros(B, bool)
    okf = np.zeros(B, bool)
    for _ in range(k):
        hard, totals = core.decide(carry)
        ok = np.asarray(jax_minsum._check(jc, hard, check))
        fin = ~done & (ok | (t >= max_it))
        okf = np.where(fin, ok, okf)
        done |= fin
        t = t + ~done
        if done.all():
            break
        carry = core.step(carry, totals, jnp.asarray(~done))
    if schedule == "layered":
        hard = carry[0] < 0
    R = np.where(done[:, None, None], 0.0, np.asarray(carry[1]))
    return (np.asarray(carry[0]), R, np.asarray(hard).astype(np.int8), t,
            done.astype(np.int32), okf.astype(np.int32))


# schedule, check, rule: the JAX test's four cases (test_minsum_stream.py:
# 49-71) and bp in both schedules
CASES = [("flooding", "zero", "minsum"), ("flooding", "syndrome", "minsum"),
         ("layered", "zero", "minsum"), ("layered", "syndrome", "minsum"),
         ("flooding", "zero", "bp"), ("layered", "syndrome", "bp")]


def _sigma(rule):
    return 0.42 if rule == "minsum" else 0.6


@pytest.mark.parametrize("schedule,check,rule", CASES)
def test_stream_step_matches_the_jax_core_loop(codes, schedule, check, rule):
    jc, pc = codes
    B, k, max_it = 8, 6, 12
    chan = _chan(jc, B, _sigma(rule), seed=3, rule=rule)
    want = _jnp_loop(jc, chan, k, max_it, check, rule, schedule)
    got = _port_step(pc, chan, k, max_it, check, rule,
                     schedule == "layered")
    for a, b in zip(want[2:], got[2:]):                  # hard, t, done, okf
        np.testing.assert_array_equal(a, b)
    assert (got[1][got[4] == 1] == 0).all()     # finished slots leave zeroed
    _close(want[0], got[0], rule)                        # chan or totals
    _close(want[1], got[1], rule)                        # R


@pytest.mark.parametrize("schedule,check,rule",
                         [("layered", "syndrome", "minsum")])
def test_stream_step_matches_the_jax_kernel(codes, schedule, check, rule):
    """The JAX kernel itself, in interpret mode (about 20 s a call here, so
    one case; the others are held to the jnp loop above, as the JAX tests
    hold the kernel)."""
    jc, pc = codes
    B, k, max_it = 8, 6, 12
    chan = _chan(jc, B, _sigma(rule), seed=3, rule=rule)
    want = _jax_step(jc, chan, k, max_it, check, rule, schedule == "layered")
    got = _port_step(pc, chan, k, max_it, check, rule, schedule == "layered")
    for a, b in zip(want[1:], got[1:]):                  # R, hard, t, done, okf
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(want[0], got[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("schedule,sigma", [("flooding", 0.45),
                                            ("layered", 0.5)])
def test_two_calls_equal_one_call(codes, schedule, sigma):
    """Two k=3 calls == one k=6 call: the state carries everything.  A slot
    that finished in the first call left with its R zeroed (the engine
    refills it), so only the slots alive into the second call must have the
    one call's decisions."""
    _, pc = codes
    B, max_it = 8, 12
    chan = torch.from_numpy(_chan(pc, B, sigma, seed=9, rule="minsum"))
    z = torch.zeros(B, dtype=torch.int32)

    def state():
        return [chan.clone(), torch.zeros(B, pc.num_edges, pc.Z), z.clone(),
                z.clone(), z.clone()]

    kw = dict(check="syndrome", layered=schedule == "layered")
    one = minsum_stream.stream_step(*state(), pc, 6, max_it, **kw)
    st, alive = state(), None
    for _ in range(2):
        out = minsum_stream.stream_step(*st, pc, 3, max_it, **kw)
        st = [x for i, x in enumerate(out) if i != 2]
        alive = ~out[4].bool() if alive is None else alive
    for i in (0, 1, 3, 4, 5):             # chan, R, t, done, okf
        assert torch.equal(one[i], out[i])
    assert torch.equal(one[2][alive], out[2][alive])
    assert alive.any() and one[4].any()


# ------------------------------------------- the kernel's compressed state

def _int_view(x):
    return x.contiguous().view(torch.int32)


def _refilled(state, fresh):
    """The kernel engine's refill: fresh channel values and reset counts
    for the finished slots."""
    chan, R, t, done, okf = state
    fin = done.bool()
    return [torch.where(fin[:, None, None], fresh, chan), R,
            t * (~fin).int(), torch.zeros_like(done), torch.zeros_like(okf)]


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.8, 0.1)])
@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("name,B,sigma", [("J4_L24_Z96", 16, 0.8),
                                          ("PON_LDPC", 4, 0.75)])
def test_compressed_messages_round_trip_bitwise(name, B, sigma, layered,
                                                alpha, beta):
    """R from the plain step over a call sequence (k = 1, refill, k = 3)
    compresses and expands to itself bit for bit, -0.0 included; so does
    the fresh all-zero R."""
    code = QCBinaryCode.from_registry(name)
    rng = np.random.default_rng(B)
    chans = [torch.from_numpy(_chan(code, B, sigma, seed=s, rule="minsum"))
             for s in rng.integers(1 << 30, size=2)]
    z = torch.zeros(B, dtype=torch.int32)
    state = [chans[0], torch.zeros(B, code.num_edges, code.Z), z, z.clone(),
             z.clone()]
    seen = []
    for k, fresh in ((None, None), (1, chans[1]), (3, None)):
        if k is not None:
            out = minsum_stream.stream_step(*state, code, k, 30, alpha=alpha,
                                            beta=beta, check="syndrome",
                                            layered=layered)
            state = [x for i, x in enumerate(out) if i != 2]
            if fresh is not None:
                state = _refilled(state, fresh)
        R = state[1]
        c = minsum_stream.compress_messages(R, code)
        assert torch.equal(_int_view(minsum_stream.expand_messages(c, code)),
                           _int_view(R))
        assert (c.v1 >= 0).all() and (c.v2 >= 0).all()
        seen.append(R)
    R = seen[-1]
    assert (R != 0).any()
    if beta:                           # zero outputs with a sign
        assert (_int_view(R) == np.int32(-2**31)).any()


def test_compressed_messages_take_tied_minima():
    """A row whose two smallest |q| tie sends one magnitude on every edge;
    the compression takes index 0 there, and the round trip is exact."""
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    B = 3
    chan = torch.ones(B, code.L, code.Z)
    chan[1] = -0.5                   # every |q| ties: all outputs agree
    chan[2, :, ::2] = 0.25           # two values a row: the minima tie
    z = torch.zeros(B, dtype=torch.int32)
    out = minsum_stream.stream_step(
        chan, torch.zeros(B, code.num_edges, code.Z), z, z.clone(),
        z.clone(), code, 2, 30, check="none")
    R = out[1]
    c = minsum_stream.compress_messages(R, code)
    assert torch.equal(_int_view(minsum_stream.expand_messages(c, code)),
                       _int_view(R))
    tied = c.v1 == c.v2
    assert tied.any() and (c.am[tied] == 0).all()
