"""The port's plain grouped-layered GF(q) QSPA (cuda_ldpc_torch.ops.nb_decode
'glayered_qspa', ops/qspa_stream.py's grouped-layered stream step) and the
facts the card's kernels rest on for it, on the CPU:

* grouped-layered QSPA is serial-row layered QSPA with the rows in group
  order (the rows of a group share no VN), so K5's layered kernel walking
  the groups as waves computes it (cuda_qspa.row_waves 'glayered');
* on Tanner_74_9_Z128_GF16 the groups are the block rows in row order, so
  serial-row layered QSPA is grouped-layered QSPA there, and K6's block-row
  schedule serves both (cuda_qspa_qc.layered_is_block_rows);
* the grouped-layered stream step is the 'glayered_qspa' core's steps over
  calls with refills.

Tolerance: none.  Both sides run the same plain operations on the same
numpy-made LLRs; the JAX package holds the plain decoders
(tests/test_torch_nb_decode.py, tests/test_torch_qspa_stream.py).
"""

import numpy as np
import pytest
import torch

from cuda_ldpc_torch import NBCode
from cuda_ldpc_torch.ops import cuda_qspa_qc, nb_decode, qspa_stream

from test_torch_nb_decode import channel_llr
from test_torch_nb_maxdomain_codes import rows_in_order


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def _bits(x):
    """float32 compared bit for bit (-0.0 != 0.0)."""
    return x.view(torch.int32) if x.is_floating_point() else x


def test_glayered_qspa_is_layered_qspa_in_group_order():
    """On BDS.576.288.GF.64, whose groups are not in row order: the
    grouped-layered decode equals the serial-row decode of the code with
    its rows renumbered in group order, hard, ok and iters."""
    code = NBCode.from_registry("BDS.576.288.GF.64")
    g = nb_decode.build_graph(code)
    order = np.concatenate(nb_decode.row_groups(g.cn_links, g.cn_mask))
    assert sorted(order.tolist()) != order.tolist()
    L = torch.from_numpy(channel_llr(code, 8, 2.0, seed=5))
    ours = nb_decode.decode(L, code, "glayered_qspa", 3)
    serial = nb_decode.decode(L, rows_in_order(code, order), "layered_qspa",
                              3)
    _assert_same(ours, serial)
    assert 0 < int(ours.ok.sum()) < 8


def test_layered_qspa_is_glayered_qspa_on_tanner():
    """Tanner_74_9_Z128_GF16's row groups are its 9 block rows in row
    order: serial-row and grouped-layered QSPA are one function there."""
    code = NBCode.from_registry("Tanner_74_9_Z128_GF16")
    L = torch.from_numpy(channel_llr(code, 2, 3.3, seed=3))
    _assert_same(nb_decode.decode_layered_qspa(L, code, 2),
                 nb_decode.decode_glayered_qspa(L, code, 2))


def test_layered_is_block_rows():
    """K6 takes layered_qspa only where the row groups are the QC plan's
    block rows in order: on Tanner_74_9_Z128_GF16, not on the adjacency
    code BDS.576.288.GF.64 (no QC plan)."""
    tanner = NBCode.from_registry("Tanner_74_9_Z128_GF16")
    plan = cuda_qspa_qc.make_plan(tanner)
    assert (plan.MB, plan.Z) == (9, 128)
    assert cuda_qspa_qc.layered_is_block_rows(tanner)
    assert not cuda_qspa_qc.layered_is_block_rows(
        NBCode.from_registry("BDS.576.288.GF.64"))


def test_glayered_stream_step_is_the_core_over_calls():
    """The grouped-layered stream step (layered='glayered') over calls of
    3 and 4 passes with a refill of the finished slots between them, on
    BDS at B = 6, against the 'glayered_qspa' core's decide and step run
    slot by slot with the same accounting and refill: chan (the running
    totals), C, hard, t, done and okf after each call."""
    code = NBCode.from_registry("BDS.576.288.GF.64")
    B, max_it = 6, 4
    chans = [torch.from_numpy(channel_llr(code, B, 2.0, seed=s))
             for s in (21, 22)]
    core = nb_decode.build_core(code, "glayered_qspa")
    g = core.g
    real = torch.as_tensor(qspa_stream.real_edges(code))
    E = len(real)
    z = torch.zeros(B, dtype=torch.int32)
    state = [chans[0].clone(), torch.zeros(B, E, code.q), z.clone(),
             z.clone(), z.clone()]
    carry = core.init(chans[0])
    t = torch.zeros(B, dtype=torch.int32)
    done = torch.zeros(B, dtype=torch.bool)
    okf = torch.zeros(B, dtype=torch.bool)
    for k, fresh in ((3, chans[1]), (4, None)):
        out = qspa_stream.stream_step(*state, code, k, max_it,
                                      layered="glayered")
        hard = torch.zeros((B, g.N), dtype=torch.int32)
        for _ in range(k):
            hard_new, llr = core.decide(carry)
            hard = torch.where(done[:, None], hard, hard_new)
            ok = nb_decode._syndrome_ok(g, hard_new)
            fin = ~done & (ok | (t >= max_it))
            okf = torch.where(fin, ok, okf)
            done = done | fin
            t = t + (~done).to(torch.int32)
            if done.all():
                break
            carry = core.step(carry, llr, ~done)
        msgs = carry[1].reshape(B, -1, g.q)[:, real]
        msgs = torch.where(done[:, None, None], torch.zeros_like(msgs), msgs)
        for got, want in zip(out, (carry[0], msgs, hard, t,
                                   done.to(torch.int32),
                                   okf.to(torch.int32))):
            assert torch.equal(_bits(got), _bits(want))
        if fresh is not None:
            assert 0 < int(done.sum()) < B
            # the engine's refill: a finished slot takes a fresh channel,
            # zero messages and counts
            state = [x for i, x in enumerate(out) if i != 2]
            state[0] = torch.where(done[:, None, None], fresh, state[0])
            for x in state[2:]:
                x.masked_fill_(done, 0)
            new = core.init(fresh)
            carry = (torch.where(done[:, None, None], new[0], carry[0]),
                     torch.where(done[:, None, None, None], new[1], carry[1]))
            t = torch.where(done, 0, t)
            okf = okf & ~done
            done = torch.zeros(B, dtype=torch.bool)
