"""The host plan of row waves that K5 (csrc/qspa.cu), K7
(csrc/qspa_stream.cu) and K8 (csrc/nbms.cu) walk with their row groups
(cuda_ldpc_torch.ops.cuda_qspa.row_waves, .pick_groups), and their phase
tool (cuda_ldpc_torch.tools.nb_rows_phases), on the CPU.

The plan is right when running its waves in order, the rows of a wave at
once, gives the serial schedule bit for bit: every row appears once, the
rows of a wave touch disjoint VNs, and every pair of rows that share a VN
keeps its serial order.  The greedy colouring ``nb_decode.row_groups`` of
grouped-layered decoding does not keep that order, so it must not be the
plan.  A plain emulation holds the plan to the serial plain decoders:
``nb_decode``'s grouped-layered step, run with the waves as its groups,
equals its serial-row layered step, state for state (tolerance: none); with
the greedy groups it does not.  No JAX here: the plain decoders are held to
the JAX package by tests/test_torch_nb_decode.py and
tests/test_torch_nb_maxdomain*.py.
"""

import re

import numpy as np
import pytest
import torch

from cuda_ldpc_torch import NBCode
from cuda_ldpc_torch.ops import (_build, cuda_nbms, cuda_qspa,
                                 cuda_qspa_stream, nb_decode)
from cuda_ldpc_torch.tools import nb_rows_phases

from test_torch_nb_decode import channel_llr

# code -> (waves of the layered plan, rows of its largest wave)
CODES = {"BDS.576.288.GF.64": (8, 10),
         "LDPC_N576_K288_GF64_d1_exp": (7, 12),
         "LDPC_N576_K480_GF256_exp": (4, 3),
         "LDPC_N96_K48_GF256_d1_exp": (6, 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _waves(w):
    return [w.wave_row[a:b] for a, b in zip(w.wave_ptr[:-1], w.wave_ptr[1:])]


def _row_vns(plan):
    return [set(plan.edge_vn[plan.row_ptr[m]:plan.row_ptr[m + 1]].tolist())
            for m in range(plan.M)]


@pytest.mark.parametrize("name", list(CODES))
def test_layered_waves_keep_the_serial_order(name):
    code = NBCode.from_registry(name)
    plan = cuda_qspa.make_plan(code)
    waves = _waves(cuda_qspa.row_waves(code, "layered"))
    assert (len(waves), max(len(w) for w in waves)) == CODES[name]
    assert sorted(np.concatenate(waves).tolist()) == list(range(plan.M))
    vns = _row_vns(plan)
    level = np.empty(plan.M, dtype=np.int64)
    for i, w in enumerate(waves):
        assert (np.diff(w) > 0).all()              # ascending in a wave
        level[w] = i
        seen = set()
        for m in w:                                # disjoint VNs in a wave
            assert not seen & vns[m]
            seen |= vns[m]
    for a in range(plan.M):
        for b in range(a + 1, plan.M):
            if vns[a] & vns[b]:
                assert level[a] < level[b], (a, b)
    # each row as early as its dependencies allow
    for m in range(plan.M):
        deps = [level[a] for a in range(m) if vns[a] & vns[m]]
        assert level[m] == (max(deps) + 1 if deps else 0)


@pytest.mark.parametrize("name", list(CODES))
def test_flooding_and_serial_plans(name):
    """Flooding: one wave of every row in order; serial: a wave a row."""
    code = NBCode.from_registry(name)
    M = code.m_sym
    flood = cuda_qspa.row_waves(code, "flooding")
    assert flood.wave_ptr.tolist() == [0, M]
    assert flood.wave_row.tolist() == list(range(M))
    serial = cuda_qspa.row_waves(code, "serial")
    assert serial.wave_ptr.tolist() == list(range(M + 1))
    assert serial.wave_row.tolist() == list(range(M))
    for w in (flood, serial):
        assert w.wave_ptr.dtype == w.wave_row.dtype == np.int32
    with pytest.raises(ValueError, match="unknown wave schedule"):
        cuda_qspa.row_waves(code, "grouped")


def test_the_plan_is_not_the_greedy_colouring(monkeypatch):
    """The plan never calls ``row_groups``; on BDS the greedy colouring
    puts a later row before an earlier one that shares a VN with it, so it
    cannot stand in for the serial order."""
    def refuse(*a, **k):
        raise AssertionError("row_groups called")

    code = NBCode.from_registry("BDS.576.288.GF.64")
    monkeypatch.setattr(nb_decode, "row_groups", refuse)
    monkeypatch.setattr(cuda_qspa, "_WAVES", {})
    cuda_qspa.row_waves(code, "layered")
    monkeypatch.undo()
    plan = cuda_qspa.make_plan(code)
    vns = _row_vns(plan)
    color = np.empty(plan.M, dtype=np.int64)
    for c, rows in enumerate(nb_decode.row_groups(code.cn_links,
                                                  code.cn_mask)):
        color[rows] = c
    swapped = sum(color[a] > color[b] for a in range(plan.M)
                  for b in range(a + 1, plan.M) if vns[a] & vns[b])
    assert swapped == 17


def _step_states(code, method, L, passes):
    """The decoder core's carry after each of ``passes`` passes, every frame
    running."""
    core = nb_decode.build_core(code, method)
    carry = core.init(L)
    cont = torch.ones(L.shape[0], dtype=torch.bool)
    states = []
    for _ in range(passes):
        carry = core.step(carry, core.decide(carry)[1], cont)
        states.append([x.clone() for x in carry])
    return states


@pytest.mark.parametrize("method", ["layered_tmm", "layered_qspa"])
def test_waves_emulate_the_serial_schedule(monkeypatch, method):
    """nb_decode's grouped-layered step with the waves as its groups (the
    rows of a wave at once) equals the serial-row step bit for bit, totals
    and messages, over two passes on BDS; with the greedy colouring's
    groups it does not; and the decode's hard, ok and iters agree too."""
    code = NBCode.from_registry("BDS.576.288.GF.64")
    L = torch.from_numpy(channel_llr(code, 4, 2.0, seed=9))
    grouped = "g" + method
    serial = _step_states(code, method, L, 2)
    greedy = _step_states(code, grouped, L, 1)
    assert not all(torch.equal(a, b) for a, b in zip(greedy[0], serial[0]))
    waves = _waves(cuda_qspa.row_waves(code, "layered"))
    monkeypatch.setattr(nb_decode, "row_groups", lambda *a: waves)
    for got, want in zip(_step_states(code, grouped, L, 2), serial):
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(nb_decode.decode(L, code, grouped, 3),
                    nb_decode.decode(L, code, method, 3)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(CODES))
def test_row_groups_fit_a_block(name):
    """K7's and K8's blocks with the groups they pick: at most 7 groups
    (named barriers 1-7), 1024 threads for one group and 512 for more,
    227 KB of shared memory, and no more groups than rows."""
    code = NBCode.from_registry(name)
    plan = cuda_qspa.make_plan(code)
    picks = [(cuda_nbms, cuda_nbms.groups(plan, m))
             for m in ("ems", "tmm", "layered_tmm")]
    picks += [(cuda_qspa_stream, cuda_qspa_stream.groups(plan, lay))
              for lay in (False, True)]
    for mod, g in picks:
        assert 1 <= g <= min(7, plan.M)
        assert 32 * plan.max_dc * g <= (1024 if g == 1 else 512)
        assert mod.smem_bytes(plan, g) <= cuda_qspa.SMEM_LIMIT
    assert cuda_qspa_stream.smem_bytes(plan) == cuda_qspa.smem_bytes(plan)


def test_phase_tool_reads_both_kernels():
    """The tool's phases are qspa_common.cuh's enum; both kernels stamp the
    per-pass phases and flush their counters, and the row phases sit in
    the shared row functions."""
    common = (_build.CSRC_DIR / "qspa_common.cuh").read_text()
    assert nb_rows_phases.phase_names(common) == nb_rows_phases.PHASES
    for name, reader, _ in nb_rows_phases.SOURCES:
        src = (_build.CSRC_DIR / name).read_text()
        out = nb_rows_phases.patched_source(src, common)
        assert out.startswith("#define NB_ROWS_PHASES 1\n")
        assert reader in src and "ROWS_PHASE_FLUSH" in src
        marks = set(re.findall(r"pc\.stamp\((kRp\w+)\)", src + common))
        assert {"kRpSetup", "kRpDecide", "kRpEdges", "kRpOutput",
                "kRpWaveWait", "kRpExit"} <= marks
    with pytest.raises(ValueError, match="RowsPhase"):
        nb_rows_phases.patched_source("", "// no enum here\n")


def test_phase_tool_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("runs the measurement on a card")
    assert nb_rows_phases.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
