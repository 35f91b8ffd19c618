"""The CUDA stream steps (cuda_ldpc_torch.ops.cuda_minsum_stream, K4;
cuda_ldpc_torch.ops.cuda_qspa_stream, K7) against their plain PyTorch
versions (ops/minsum_stream.py, ops/qspa_stream.py), over sequences of
calls with a refill of the finished slots between them, as the stream
engines make them.

Tolerance: none.  K4 does the plain version's fp32 adds, compares and
multiplies in its order, and its logf/tanhf agree with torch.log/torch.tanh
on the card (as for K1-K3), so every output and every state tensor must be
exactly equal.  K7 follows the plain version's order of the softmax, the
transforms and the products (as K5 does), so t, done, okf, hard, C and the
layered totals must be exactly equal too.

The kernel cases need a card and skip without one.  The file imports only
the port, so on a machine with a card and no JAX it runs on its own:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_stream.py
"""

import numpy as np
import pytest
import torch

from cuda_ldpc_torch import NBCode, QCBinaryCode
from cuda_ldpc_torch.ops import (channel, cuda_minsum_stream,
                                 cuda_qspa_stream, demod, minsum_stream,
                                 qspa_stream)
from cuda_ldpc_torch.utils.constellations import constellation


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _binary_chan(code, sigma, batch, gen, rule):
    chan = channel.bpsk_awgn_llr(gen, torch.zeros(code.L, code.Z), sigma,
                                 batch)
    return chan * (2.0 / sigma**2) if rule == "bp" else chan


def _nb_chan(code, sigma, batch, gen):
    labels = np.zeros(code.bit_length, dtype=np.int64)
    return demod.nb_channel_llr(gen, labels, constellation(2), sigma, batch,
                                code.q)


def _state(chan, msg_shape):
    B = chan.shape[0]
    z = torch.zeros(B, dtype=torch.int32)
    return [chan, torch.zeros((B,) + msg_shape), z, z.clone(), z.clone()]


def _refill(state, fresh):
    """What the kernel engine does between calls: fresh channel values for
    the finished slots, their counts reset."""
    chan, msgs, t, done, okf = state
    fin = done.bool()
    chan = torch.where(fin.reshape(-1, *([1] * (chan.dim() - 1))), fresh, chan)
    return [chan, msgs, t * (~fin).int(), torch.zeros_like(done),
            torch.zeros_like(okf)]


def _run_both(kernel_step, plain_step, state, calls, dev):
    """The same call sequence through the kernel and the plain version,
    both on the card, comparing every output after each call."""
    ks = [x.to(dev) for x in state]
    ps = [x.to(dev) for x in state]
    for k, fresh in calls:
        out_k = kernel_step(*ks, k=k)
        out_p = plain_step(*ps, k=k)
        names = ("chan", "msgs", "hard", "t", "done", "okf")
        for name, a, b in zip(names, out_k, out_p):
            assert torch.equal(a, b), (name, k)
        ks = [x for i, x in enumerate(out_k) if i != 2]
        ps = [x for i, x in enumerate(out_p) if i != 2]
        if fresh is not None:
            ks = _refill(ks, fresh.to(dev))
            ps = _refill(ps, fresh.to(dev))


# ---------------------------------------------------------------- CPU side

def test_cpu_tensors_take_the_plain_versions():
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    gen = torch.Generator().manual_seed(1)
    chan = _binary_chan(code, 0.6, 5, gen, "minsum")
    before = dict(cuda_minsum_stream.LAUNCHES)
    a = cuda_minsum_stream.stream_step(*_state(chan.clone(),
                                               (code.num_edges, code.Z)),
                                       code, 3, 10)
    b = minsum_stream.stream_step(*_state(chan.clone(),
                                          (code.num_edges, code.Z)),
                                  code, 3, 10)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert cuda_minsum_stream.LAUNCHES == before

    nb = NBCode.from_registry("BDS.576.288.GF.64")
    L = _nb_chan(nb, 0.9, 3, gen)
    E = int(nb.cn_mask.sum())
    before = dict(cuda_qspa_stream.LAUNCHES)
    a = cuda_qspa_stream.stream_step(*_state(L.clone(), (E, nb.q)), nb, 2, 6)
    b = qspa_stream.stream_step(*_state(L.clone(), (E, nb.q)), nb, 2, 6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert cuda_qspa_stream.LAUNCHES == before


def test_stream_kernel_takes_the_k5_codes():
    for name in ("BDS.576.288.GF.64", "LDPC_N96_K48_GF256_d1_exp"):
        assert cuda_qspa_stream.supports(NBCode.from_registry(name))
    assert not cuda_qspa_stream.supports(
        NBCode.from_registry("Tanner_74_9_Z128_GF16"))


def test_bad_state_is_refused():
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    st = _state(torch.zeros(2, code.L, code.Z), (code.num_edges, code.Z))
    with pytest.raises(ValueError, match="k must"):
        minsum_stream.stream_step(*st, code, 0, 5)
    st[2] = st[2].long()
    with pytest.raises(ValueError, match="int32"):
        minsum_stream.stream_step(*st, code, 1, 5)


# ---------------------------------------------------------------- the card

# code, Es/N0 sigma, batch, max_iters, check
K4_CASES = [
    ("J4_L24_Z96", 0.62, 37, 12, "zero"),
    ("J4_L24_Z96", 0.62, 37, 12, "syndrome"),
    ("PON_LDPC", 0.76, 64, 20, "zero"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["minsum", "bp"])
@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("name,sigma,B,max_it,check", K4_CASES)
def test_k4_equals_plain_over_calls(cuda, name, sigma, B, max_it, check,
                                    layered, rule):
    code = QCBinaryCode.from_registry(name)
    gen = torch.Generator().manual_seed(B + max_it)
    chans = [_binary_chan(code, sigma, B, gen, rule) for _ in range(3)]
    kw = dict(code=code, max_iters=max_it, check=check, rule=rule,
              layered=layered, alpha=0.8 if layered else 1.0)

    def kernel(*s, k):
        return cuda_minsum_stream.stream_step(*s, k=k, **kw)

    def plain(*s, k):
        return minsum_stream.stream_step(*s, k=k, **kw)

    before = dict(cuda_minsum_stream.LAUNCHES)
    # k = 1, k = 5 with a refill after each, then the drain
    _run_both(kernel, plain, _state(chans[0], (code.num_edges, code.Z)),
              [(1, chans[1]), (5, chans[2]), (max_it + 1, None)], cuda)
    name_k = f"{rule}_stream_{'layered' if layered else 'flooding'}"
    assert cuda_minsum_stream.LAUNCHES[name_k] == before[name_k] + 3


@pytest.mark.cuda
@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("name,sigma", [("BDS.576.288.GF.64", 0.95),
                                        ("LDPC_N96_K48_GF256_d1_exp", 0.6),
                                        ("LDPC_N576_K480_GF256_exp", 0.45)])
def test_k7_equals_plain_over_calls(cuda, name, sigma, layered):
    code = NBCode.from_registry(name)
    gen = torch.Generator().manual_seed(7)
    B, max_it = 19, 8
    chans = [_nb_chan(code, sigma, B, gen) for _ in range(3)]
    E = int(code.cn_mask.sum())
    kw = dict(code=code, max_iters=max_it, layered=layered)

    def kernel(*s, k):
        return cuda_qspa_stream.stream_step(*s, k=k, **kw)

    def plain(*s, k):
        return qspa_stream.stream_step(*s, k=k, **kw)

    _run_both(kernel, plain, _state(chans[0], (E, code.q)),
              [(1, chans[1]), (3, chans[2]), (max_it + 1, None)], cuda)
