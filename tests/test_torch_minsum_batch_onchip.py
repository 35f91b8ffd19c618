"""The stop protocol of the on-chip min-sum batch kernels K1 and K2
(csrc/onchip.cuh, `onchip_batch`), emulated in plain PyTorch from the port's
stream step (ops/minsum_stream.stream_step) and the compressed form the
kernels keep on chip (compress_messages / expand_messages), against the
plain batch decoders ops/minsum.decode_flooding / decode_layered and, for
one case, the JAX package's decode_flooding.

The protocol: (first) each frame runs from R = 0 until its own check first
passes at k_b, or to num_iters, and saves its state compressed (flooding:
the R that fed iteration k_b's VN phase; layered: the totals and R after
iteration k_b); (resume) every frame with k_b < K = max k_b goes on from its
saved state to K; (step) while some frame fails at the batch's iteration
and num_iters is not reached, every frame goes one iteration on from its
saved state.  Without early stop, or with check 'none', every frame runs
num_iters iterations.

Tolerance: none -- hard, ok and iters equal bit for bit, since every path
does the same fp32 operations in the same order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu import QCBinaryCode as JaxCode
from cuda_ldpc_tpu.ops import minsum as jax_minsum
from cuda_ldpc_torch import QCBinaryCode
from cuda_ldpc_torch.ops import minsum, minsum_stream
# the crafted input the card tests share (that file imports no JAX)
from test_torch_cuda_minsum import passes_then_fails


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CODE = QCBinaryCode.from_registry("J4_L24_Z96")


def _llrs(B, sigma, seed):
    """All-zero codeword through BPSK + AWGN, made with numpy."""
    rng = np.random.default_rng(seed)
    return (1.0 + sigma * rng.standard_normal(
        (B, CODE.L, CODE.Z))).astype(np.float32)


def _where(sel, new, old):
    return torch.where(sel.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


class _Frames:
    """A batch's per-frame state, advanced one iteration at a time by the
    stream step (one pass, check 'none', so that no slot finishes), and its
    saved form, compressed as the kernels keep it."""

    def __init__(self, chan, alpha, beta, layered):
        self.chan, self.layered = chan, layered
        self.kw = dict(alpha=alpha, beta=beta, check="none", layered=layered)
        self.zeros = torch.zeros(chan.shape[0], dtype=torch.int32)

    def start(self):
        R = torch.zeros((self.chan.shape[0], CODE.num_edges, CODE.Z))
        return (self.chan.clone(), R) if self.layered else R

    def _step(self, x, R, t, max_iters):
        z = self.zeros
        return minsum_stream.stream_step(x.clone(), R.clone(), t, z.clone(),
                                         z.clone(), CODE, 1, max_iters,
                                         **self.kw)

    def advance(self, state, i):
        """State after iteration i -> (state after i + 1, its hard).  The
        flooding state is the R that iteration's VN phase reads; the first
        iteration reads R = 0 (no CN phase before it)."""
        if self.layered:
            T, R, hard = self._step(*state, self.zeros.clone(), 10**6)[:3]
            return (T, R), hard
        R = state
        if i > 0:                           # the CN phase of iteration i
            R = self._step(self.chan, R, self.zeros.clone(), 10**6)[1]
        # the VN phase alone: a slot at max_iters finishes at its decide
        hard = self._step(self.chan, R, self.zeros + 1, 0)[2]
        return R, hard

    def save(self, state):
        if self.layered:
            return (state[0].clone(),
                    minsum_stream.compress_messages(state[1], CODE))
        return minsum_stream.compress_messages(state, CODE)

    def restore(self, saved):
        if self.layered:
            return (saved[0].clone(),
                    minsum_stream.expand_messages(saved[1], CODE))
        return minsum_stream.expand_messages(saved, CODE)

    def select(self, sel, new, old):
        if self.layered:
            return (_where(sel, new[0], old[0]),
                    self.select_saved(sel, new[1], old[1])
                    if isinstance(new[1], tuple) else
                    _where(sel, new[1], old[1]))
        if isinstance(new, tuple):
            return self.select_saved(sel, new, old)
        return _where(sel, new, old)

    @staticmethod
    def select_saved(sel, new, old):
        return type(new)(*(_where(sel, a, b) for a, b in zip(new, old)))


def run_protocol(chan, num_iters, alpha=1.0, beta=0.0, check="syndrome",
                 early_stop=True, layered=False):
    """The kernels' schedule; returns (hard, ok, iters, K, resumed frames,
    lockstep launches that ran)."""
    B = chan.shape[0]
    frames = _Frames(chan, alpha, beta, layered)

    def ok_of(hard):
        return minsum._check(CODE, hard.bool(), check)

    stop = early_stop and check != "none"
    # first: each frame to its own stop
    state = frames.start()
    saved = frames.save(state)
    hard = torch.zeros((B, CODE.L, CODE.Z), dtype=torch.int8)
    ok = torch.zeros(B, dtype=torch.bool)
    kb = torch.zeros(B, dtype=torch.int64)
    running = torch.ones(B, dtype=torch.bool)
    for i in range(num_iters):
        state, h = frames.advance(state, i)
        o = ok_of(h)
        fin = running & ((o & stop) | (i + 1 >= num_iters))
        hard, ok = _where(fin, h, hard), torch.where(fin, o, ok)
        kb = torch.where(fin, i + 1, kb)
        if stop:
            saved = frames.select(fin, frames.save(state), saved)
        running &= ~fin
        if not bool(running.any()):
            break
    K = int(kb.max())
    if not stop:
        return hard, ok, K, K, 0, 0
    # resume: the frames behind, from their saved state, on to K
    state, at = frames.restore(saved), kb.clone()
    resumed = int((kb < K).sum())
    while bool((at < K).any()):
        sel = at < K
        new, h = frames.advance(state, 1)
        state, at = frames.select(sel, new, state), at + sel
        reached = sel & (at == K)
        hard = _where(reached, h, hard)
        ok = torch.where(reached, ok_of(h), ok)
    saved = frames.save(state)
    # step: every frame one iteration a launch, from its saved state
    iters, steps = K, 0
    while not bool(ok.all()) and iters < num_iters:
        state, hard = frames.advance(frames.restore(saved), iters)
        saved = frames.save(state)
        ok = ok_of(hard)
        iters += 1
        steps += 1
    return hard, ok, iters, K, resumed, steps


def _plain(chan, num_iters, layered, **kw):
    decode = minsum.decode_layered if layered else minsum.decode_flooding
    return decode(chan, CODE, num_iters, **kw)


def _assert_same(got, want):
    hard, ok, iters = got[:3]
    assert torch.equal(hard, want.hard)
    assert torch.equal(ok, want.ok)
    assert iters == int(want.iters)


# sigma, batch, iterations, check, early stop, alpha, beta
CASES = [
    (0.50, 48, 12, "zero", True, 1.0, 0.0),
    (0.52, 48, 12, "syndrome", True, 0.8, 0.1),
    (0.62, 32, 8, "none", True, 1.0, 0.0),
    (0.55, 32, 8, "zero", False, 0.8, 0.1),
    (0.55, 32, 8, "syndrome", False, 1.0, 0.0),
    (0.53, 64, 16, "syndrome", True, 1.0, 0.0),
]


@pytest.mark.parametrize("layered", [False, True], ids=["flooding",
                                                         "layered"])
@pytest.mark.parametrize("sigma,B,iters,check,early,alpha,beta", CASES,
                         ids=[f"{c[3]}-early{int(c[4])}-a{c[5]}b{c[6]}-s{c[0]}"
                              for c in CASES])
def test_protocol_equals_the_batch_decoder(layered, sigma, B, iters, check,
                                           early, alpha, beta):
    chan = torch.from_numpy(_llrs(B, sigma, seed=B + iters))
    kw = dict(alpha=alpha, beta=beta, check=check, early_stop=early)
    got = run_protocol(chan, iters, layered=layered, **kw)
    _assert_same(got, _plain(chan, iters, layered, **kw))
    if early and check != "none":
        # the frames stop at different iterations: some are resumed
        assert got[4] > 0


@pytest.mark.parametrize("layered", [False, True], ids=["flooding",
                                                         "layered"])
def test_a_frame_that_passes_then_fails_takes_the_lockstep(layered):
    chan = torch.from_numpy(passes_then_fails())
    kw = dict(check="zero", early_stop=True)
    got = run_protocol(chan, 20, layered=layered, **kw)
    _assert_same(got, _plain(chan, 20, layered, **kw))
    hard, ok, iters, K, resumed, steps = got
    assert K == (3 if layered else 7)
    assert resumed == 1 and steps > 0 and iters > K


def test_protocol_equals_the_jax_decoder():
    """The same inputs through the JAX package's decode_flooding on the CPU:
    the emulated schedule, the port's plain decoder and JAX agree."""
    llrs = _llrs(48, 0.52, seed=60)
    jc = JaxCode.from_registry(CODE.name)
    want = jax_minsum.decode_flooding(jnp.asarray(llrs), jc, 12, alpha=0.8,
                                      beta=0.1, check="zero")
    hard, ok, iters = run_protocol(torch.from_numpy(llrs), 12, alpha=0.8,
                                   beta=0.1, check="zero")[:3]
    np.testing.assert_array_equal(np.asarray(want.hard), hard.numpy())
    np.testing.assert_array_equal(np.asarray(want.ok), ok.numpy())
    assert int(want.iters) == iters
