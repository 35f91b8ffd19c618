"""The CUDA stream steps (cuda_ldpc_torch.ops.cuda_minsum_stream, K4;
cuda_ldpc_torch.ops.cuda_qspa_stream, K7) against their plain PyTorch
versions (ops/minsum_stream.py, ops/qspa_stream.py), over sequences of
calls with a refill of the finished slots between them, as the stream
engines make them.

Tolerance: none.  K4 does the plain version's fp32 adds, compares and
multiplies in its order, and its logf/tanhf agree with torch.log/torch.tanh
on the card (as for K1-K3), so every output and every state tensor must be
exactly equal.  K4's min-sum keeps each slot's state on chip in a
compressed form that is R bit for bit, so it must also equal the
global-memory design (``global_stream_step``) exactly, and take a state the
plain version built on the CPU.  ``onchip.onchip_plan`` (where the state
lives: the cluster size and the shared-memory layout, shared with the batch
kernels K1 and K2) is checked on the CPU.  K7
follows the plain version's order of the softmax, the transforms and the
products (as K5 does), so t, done, okf, hard, C and the layered totals
must be exactly equal too, and its row groups (the rows of a pass at once,
layered by dependency level) must equal its serial design (one row at a
time, ``stream_step_serial``) in every state tensor.

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
                                 onchip, qspa_stream)
from cuda_ldpc_torch.utils.constellations import constellation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One CPU thread: with several, the OpenMP team torch gets can vary
    under load, which moves the split between the vectorised and the scalar
    exp/log and so the last bits of the plain GF(q) step's messages."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def _plan_tables(plan, code):
    """The plan's table split into its arrays (csrc/minsum_stream.cu)."""
    L, J = code.L, code.J
    m = onchip.MAX_CLUSTER + 1
    tab, cs = plan.table, plan.cluster
    out = dict(col_start=tab[:cs + 1], row_start=tab[m:m + cs + 1])
    i = 2 * m
    for name, n in (("col_order", L), ("row_order", J), ("col_rank", L),
                    ("col_off", L), ("chan_off", L), ("row_rank", J),
                    ("row_off", J)):
        out[name] = tab[i:i + n]
        i += n
    assert i == len(tab)
    return out


@pytest.mark.parametrize("name,layered,cluster,keep_chan", [
    ("J15_L30_Z1280", False, 2, False), ("J15_L30_Z1280", True, 2, False),
    ("PON_LDPC", False, 1, True), ("PON_LDPC", True, 1, False),
    ("J4_L24_Z96", False, 1, True), ("J48_L60_Z160", False, 1, True)])
def test_onchip_plan_picks_the_smallest_cluster(name, layered, cluster,
                                                keep_chan):
    """Each block owns the columns and rows its lists name; its columns,
    chan and row states lie after its header, within its bytes and apart
    from each other; the cluster is the smallest that holds T and the
    compressed state."""
    code = QCBinaryCode.from_registry(name)
    plan = onchip.onchip_plan(code, layered)
    assert (plan.cluster, plan.keep_chan, plan.wide) == (cluster, keep_chan,
                                                         False)
    assert plan.smem_bytes == max(plan.block_bytes) <= \
        onchip.SMEM_PER_BLOCK
    L, J, Z, E, cs = code.L, code.J, code.Z, code.num_edges, plan.cluster
    t = _plan_tables(plan, code)
    assert t["col_start"][-1] == L and t["row_start"][-1] == J
    for c in range(cs):
        mine = t["col_order"][t["col_start"][c]:t["col_start"][c + 1]]
        assert (t["col_rank"][mine] == c).all()
        mine = t["row_order"][t["row_start"][c]:t["row_start"][c + 1]]
        assert (t["row_rank"][mine] == c).all()
    assert sorted(t["col_order"]) == list(range(L))
    assert sorted(t["row_order"]) == list(range(J))
    header = 32 + 16 * E + 4 * (4 * L + 3 * J + 2)
    assert onchip.header_bytes(code) >= header
    spans = {c: [] for c in range(cs)}
    for l in range(L):
        spans[t["col_rank"][l]].append((t["col_off"][l], 4 * Z))
        if keep_chan:
            spans[t["col_rank"][l]].append((t["chan_off"][l], 4 * Z))
    assert (t["chan_off"] >= 0).all() == keep_chan
    for j in range(J):
        spans[t["row_rank"][j]].append((t["row_off"][j], 12 * Z))
    for c, sp in spans.items():
        sp.sort()
        assert sp[0][0] >= header
        assert all(a + n <= b for (a, n), (b, _) in zip(sp, sp[1:]))
        assert sp[-1][0] + sp[-1][1] <= plan.block_bytes[c]
    if cluster > 1:
        with pytest.raises(ValueError):
            onchip.onchip_plan(code, layered, cluster=1)


def test_onchip_plan_keeps_few_edges_across_the_cluster():
    """J15_L30_Z1280 on two blocks: the contiguous split leaves 59 of its
    115 edges across the blocks; the planner's ownership at most 45, with
    the columns and rows as evenly shared."""
    code = QCBinaryCode.from_registry("J15_L30_Z1280")
    t = _plan_tables(onchip.onchip_plan(code, False), code)
    H = code.base >= 0
    contiguous = onchip._cross_edges(
        H, np.arange(code.L) * 2 // code.L, np.arange(code.J) * 2 // code.J)
    assert contiguous == 59
    assert onchip._cross_edges(H, t["col_rank"],
                                           t["row_rank"]) <= 45
    assert sorted(np.bincount(t["col_rank"])) == [14, 16]
    assert sorted(np.bincount(t["row_rank"])) == [7, 8]


def test_onchip_plan_keeps_chan_in_a_cluster_of_4():
    code = QCBinaryCode.from_registry("J15_L30_Z1280")
    plan = onchip.onchip_plan(code, False, cluster=4)
    assert plan.cluster == 4 and plan.keep_chan
    assert plan.smem_bytes <= onchip.SMEM_PER_BLOCK


def test_onchip_plan_refuses_what_no_cluster_holds():
    rng = np.random.default_rng(0)
    base = np.where(rng.random((40, 80)) < 0.1,
                    rng.integers(0, 4096, (40, 80)), -1)
    big = QCBinaryCode(name="big", base=base, Z=4096)   # 1.3 + 2.0 MB
    with pytest.raises(ValueError, match="shared memory"):
        onchip.onchip_plan(big, False)
    dense = QCBinaryCode(name="dense", base=np.zeros((2, 60), np.int64), Z=8)
    with pytest.raises(ValueError, match="row degree 60"):
        onchip.onchip_plan(dense, True)
    wide = QCBinaryCode(name="wide", base=np.zeros((2, 30), np.int64), Z=8)
    assert onchip.onchip_plan(wide, True).wide


def test_edge_positions_follow_the_rows():
    code = QCBinaryCode.from_registry("PON_LDPC")
    row, pos = onchip.edge_positions(code)
    for j, edges in enumerate(code.row_edges):
        assert (row[edges] == j).all()
        assert (pos[edges] == np.arange(len(edges))).all()


# ---------------------------------------------------------------- the card

# code, Es/N0 sigma, batch, max_iters, check
K4_CASES = [
    ("J4_L24_Z96", 0.62, 37, 12, "zero"),
    ("J4_L24_Z96", 0.62, 37, 12, "syndrome"),
    ("PON_LDPC", 0.76, 64, 20, "zero"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("beta", [0.0, 0.1])
@pytest.mark.parametrize("rule", ["minsum", "bp"])
@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("name,sigma,B,max_it,check", K4_CASES)
def test_k4_equals_plain_over_calls(cuda, name, sigma, B, max_it, check,
                                    layered, rule, beta):
    code = QCBinaryCode.from_registry(name)
    gen = torch.Generator().manual_seed(B + max_it)
    chans = [_binary_chan(code, sigma, B, gen, rule) for _ in range(3)]
    kw = dict(code=code, max_iters=max_it, check=check, rule=rule,
              layered=layered, alpha=0.8 if layered or beta else 1.0,
              beta=beta)

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


# an odd lifting size: the on-chip kernel's lane pairs (p, p + 4) leave
# lane 7 unpaired
ODD = QCBinaryCode(name="odd7", base=np.array([[0, 1, 2, -1, 3, 5],
                                               [4, -1, 0, 1, 6, 2]]), Z=7)

# rows of 30 edges: 64-bit check-node words
WIDE = QCBinaryCode(name="wide30", base=np.arange(60).reshape(2, 30) % 16,
                    Z=16)

# code, Es/N0 sigma, batch, max_iters, check, alpha, beta
ONCHIP_CASES = [
    ("odd7", 0.6, 19, 12, "syndrome", 0.8, 0.1),
    ("wide30", 0.45, 19, 12, "syndrome", 0.8, 0.1),
    ("J4_L24_Z96", 0.62, 37, 12, "syndrome", 0.8, 0.1),
    ("PON_LDPC", 0.76, 64, 20, "zero", 1.0, 0.0),
    ("J15_L30_Z1280", 0.84, 4096, 20, "zero", 1.0, 0.0),
    ("J15_L30_Z1280", 0.84, 4096, 20, "syndrome", 0.8, 0.1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("name,sigma,B,max_it,check,alpha,beta",
                         ONCHIP_CASES)
def test_k4_onchip_equals_plain_and_the_global_design(
        cuda, name, sigma, B, max_it, check, alpha, beta, layered):
    """The on-chip min-sum (J15_L30_Z1280 on a cluster of 2, and of 4 with
    chan on chip) against the plain step and the global-memory design over
    one call sequence."""
    code = ({"odd7": ODD, "wide30": WIDE}.get(name)
            or QCBinaryCode.from_registry(name))
    gen = torch.Generator().manual_seed(B + max_it + 1)
    chans = [_binary_chan(code, sigma, B, gen, "minsum") for _ in range(3)]
    kw = dict(code=code, max_iters=max_it, check=check, layered=layered,
              alpha=alpha, beta=beta)
    calls = [(1, chans[1]), (5, chans[2]), (max_it + 1, None)]
    start = _state(chans[0], (code.num_edges, code.Z))
    plans = [None]
    if code.name == "J15_L30_Z1280" and not layered:
        plans.append(onchip.onchip_plan(code, False, cluster=4))
    for plan in plans:
        def kernel(*s, k):
            return cuda_minsum_stream.onchip_step(*s, k=k, plan=plan, **kw)

        def plain(*s, k):
            return minsum_stream.stream_step(*s, k=k, **kw)

        def global_design(*s, k):
            return cuda_minsum_stream.global_stream_step(*s, k=k, **kw)

        _run_both(kernel, plain, start, calls, cuda)
        _run_both(kernel, global_design, start, calls, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("name,B", [("J4_L24_Z96", 16), ("PON_LDPC", 8)])
def test_k4_takes_a_state_the_plain_version_built(cuda, name, B, layered):
    """Two calls on the CPU (the plain version), then the state moves to the
    card: the kernel's next call equals the plain version's on the CPU."""
    code = QCBinaryCode.from_registry(name)
    gen = torch.Generator().manual_seed(5)
    chans = [_binary_chan(code, 0.75, B, gen, "minsum") for _ in range(2)]
    kw = dict(code=code, max_iters=30, check="syndrome", layered=layered,
              alpha=0.8, beta=0.1)
    st = _state(chans[0], (code.num_edges, code.Z))
    for k, fresh in ((1, chans[1]), (2, None)):
        out = minsum_stream.stream_step(*st, k=k, **kw)
        st = [x for i, x in enumerate(out) if i != 2]
        if fresh is not None:
            st = _refill(st, fresh)
    assert (st[1] != 0).any()
    want = minsum_stream.stream_step(*[x.clone() for x in st], k=4, **kw)
    got = cuda_minsum_stream.stream_step(*[x.to(cuda) for x in st], k=4,
                                         **kw)
    for name_, a, b in zip(("chan", "R", "hard", "t", "done", "okf"), got,
                           want):
        assert torch.equal(a.cpu(), b), name_


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


@pytest.mark.cuda
@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("name,sigma", [("BDS.576.288.GF.64", 0.95),
                                        ("LDPC_N576_K288_GF64_d1_exp", 0.8),
                                        ("LDPC_N96_K48_GF256_d1_exp", 0.6),
                                        ("LDPC_N576_K480_GF256_exp", 0.45)])
def test_k7_row_groups_equal_the_serial_design_over_calls(cuda, name, sigma,
                                                          layered):
    """K7's row groups (flooding: every row of a pass at once; layered: by
    dependency level) against the serial design, one row at a time, over a
    call sequence with refills: every state tensor bit for bit."""
    code = NBCode.from_registry(name)
    gen = torch.Generator().manual_seed(11)
    B, max_it = 37, 8
    chans = [_nb_chan(code, sigma, B, gen) for _ in range(3)]
    E = int(code.cn_mask.sum())
    kw = dict(code=code, max_iters=max_it, layered=layered)
    key = f"qspa_stream_serial_{'layered' if layered else 'flooding'}"
    before = cuda_qspa_stream.LAUNCHES[key]

    def kernel(*s, k):
        return cuda_qspa_stream.stream_step(*s, k=k, **kw)

    def serial(*s, k):
        return cuda_qspa_stream.stream_step_serial(*s, k=k, **kw)

    _run_both(kernel, serial, _state(chans[0], (E, code.q)),
              [(1, chans[1]), (3, chans[2]), (max_it + 1, None)], cuda)
    assert cuda_qspa_stream.LAUNCHES[key] == before + 3

