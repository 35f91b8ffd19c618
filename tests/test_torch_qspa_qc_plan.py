"""The host side of the staged QC GF(q) QSPA kernel K6
(cuda_ldpc_torch.ops.cuda_qspa_qc: ``stage_runs``, ``coefficient_logs``,
``smem_bytes``) and of its phase tool (cuda_ldpc_torch.tools
.qspa_qc_phases), on the CPU, on Tanner_74_9_Z128_GF16 and the fully QC
synthetic codes of tests/test_pallas_qspa_qc.py (GF(4), GF(16), GF(32)).

Each chunk's staged copies must cover exactly the VNs and message rows the
plain version gathers (nb_decode: check row m's edge at slot d reads the
totals of VN cn_links[m, d] and its own message); the coefficient logs,
through the kernel's y / h = alpha^(log y + q - 1 - log h), must give the
plain version's symbol permutation and equal the JAX package's rotation
amounts (pallas_qspa_qc.py's ``iz``); the block's shared memory must fit,
and on Tanner twice over, so that two frames share an SM.  All exact:
integer tables.
"""

import re

import numpy as np
import pytest
import torch

from cuda_ldpc_tpu.models.nb_code import NBCode as JaxNBCode
from cuda_ldpc_tpu.ops import pallas_qspa_qc as jax_qc
from cuda_ldpc_torch.ops import _build, cuda_qspa, cuda_qspa_qc, nb_decode
from cuda_ldpc_torch.tools import probe_mosaic, qspa_qc_phases

from test_pallas_qspa_qc import synthetic_qc_code
from test_torch_nb_host import port_code

CODES = ["Tanner_74_9_Z128_GF16", "synthetic_gf4", "synthetic_gf16",
         "synthetic_gf32"]
_CODES = {}


def codes(name):
    """(port code, JAX code)."""
    if name not in _CODES:
        theirs = (synthetic_qc_code(q=int(name[len("synthetic_gf"):]))
                  if name.startswith("synthetic")
                  else JaxNBCode.from_registry(name))
        _CODES[name] = (port_code(theirs), theirs)
    return _CODES[name]


@pytest.mark.parametrize("name", CODES)
def test_plan_and_coefficient_logs_match_jax(name):
    ours, theirs = codes(name)
    plan, jplan = cuda_qspa_qc.make_plan(ours), jax_qc.make_plan(theirs)
    assert cuda_qspa_qc.supports(ours)
    assert (plan.NB, plan.MB, plan.Z, plan.q, plan.EB) == (
        jplan.NB, jplan.MB, jplan.Z, jplan.q, jplan.EB)
    assert plan.row_edges == jplan.row_edges
    assert plan.col_edges == jplan.col_edges
    # the JAX kernel's rotation amount of each check row, i with h = alpha^i,
    # from its per-bit table ibits [EB * nbits, 1, Z]
    bits = jplan.ibits.reshape(jplan.EB, jplan.nbits, jplan.Z).astype(int)
    iz = (bits << np.arange(jplan.nbits)[None, :, None]).sum(axis=1)
    lgh = cuda_qspa_qc.coefficient_logs(plan)
    assert lgh.dtype == np.uint8
    np.testing.assert_array_equal(lgh.reshape(plan.EB, plan.Z), iz)


@pytest.mark.parametrize("name", CODES)
def test_stage_runs_cover_the_plain_gather(name):
    code, _ = codes(name)
    plan = cuda_qspa_qc.make_plan(code)
    Z, G = plan.Z, cuda_qspa_qc.THREADS // plan.q
    runs = cuda_qspa_qc.stage_runs(plan)
    assert runs.shape == (plan.EB * Z // G, 4) and runs.dtype == np.int32
    blk_ptr = np.cumsum([0] + [len(r) for r in plan.row_edges])
    message_rows, wraps = [], 0
    for r, row in enumerate(plan.row_edges):
        dc = len(row)
        for j in range(Z // G):
            for d, (eid, _, _) in enumerate(row):
                t_row0, t_split, t_row1, c_row0 = runs[blk_ptr[r] * Z // G
                                                       + j * dc + d]
                i = np.arange(G)
                vns = np.where(i < t_split, t_row0 + i, t_row1 + i - t_split)
                m = r * Z + j * G + i
                # the VN the plain version gathers for (check row m, slot d)
                np.testing.assert_array_equal(vns, code.cn_links[m, d])
                # the run before the wrap is contiguous, and so is the rest
                assert 1 <= t_split <= G
                wraps += t_split < G
                assert t_row1 % Z == 0 and t_row1 == vns[-1] - vns[-1] % Z
                # the message of (m, d): block edge eid, row z = m - r Z
                np.testing.assert_array_equal(c_row0 + i, eid * Z + j * G + i)
                message_rows.append(c_row0 + i)
    # every message row is staged once
    rows = np.sort(np.concatenate(message_rows))
    np.testing.assert_array_equal(rows, np.arange(plan.EB * Z))
    assert wraps > 0                     # the split is exercised


@pytest.mark.parametrize("name", CODES)
def test_coefficient_logs_give_the_plain_permutation(name):
    code, _ = codes(name)
    plan = cuda_qspa_qc.make_plan(code)
    q, Z = plan.q, plan.Z
    gf_log, gf_exp = cuda_qspa.gf_tables(q)
    lgh = cuda_qspa_qc.coefficient_logs(plan).astype(np.int64)
    # nb_decode's U[y] = v2c[h^-1 y]: the inverse of k -> h k
    inv = np.argsort(nb_decode.build_graph(code).h_perm, axis=-1,
                     kind="stable")
    y = np.arange(q)
    for r, row in enumerate(plan.row_edges):
        for d, (eid, _, _) in enumerate(row):
            lh = lgh[eid * Z:(eid + 1) * Z, None]              # [Z, 1]
            a = np.where(y == 0, 0, gf_exp[gf_log[y] + (q - 1) - lh])
            np.testing.assert_array_equal(a, inv[r * Z:(r + 1) * Z, d])
    # and the kernel's GF multiply of the syndrome, ex[lg h + lg x]
    h = plan.hz.reshape(-1)
    x = 1 + np.arange(h.size) % (q - 1)
    np.testing.assert_array_equal(gf_exp[lgh + gf_log[x]],
                                  code.mul_table[h, x])


@pytest.mark.parametrize("name", CODES)
def test_shared_memory_fits(name):
    code, _ = codes(name)
    plan = cuda_qspa_qc.make_plan(code)
    smem = cuda_qspa_qc.smem_bytes(plan)
    assert smem <= cuda_qspa.SMEM_LIMIT               # 227 KB a block
    if name == "Tanner_74_9_Z128_GF16":
        # four [21, 256] f32 slabs, two [21, 16] byte stages of logs, 9,472
        # decisions, the int tables (GF 16 + 30, blocks 10 + 3 * 185 + 75)
        assert smem == 4 * 4 * 21 * 256 + 672 + 9472 + 4 * (46 + 640)
        # two frames an SM: the SM's 228 KB, 1 KB a block kept by the card
        assert 2 * (smem + 1024) <= 228 * 1024


def test_phase_counters_mark_both_designs():
    src = (_build.CSRC_DIR / "qspa_qc.cu").read_text()
    assert qspa_qc_phases.phase_names(src) == qspa_qc_phases.PHASES
    out = qspa_qc_phases.patched_source(src)
    assert out.startswith("#define QSPA_QC_PHASES 1\n")
    for kernel, design in (("qspa_qc_global_kernel(", 0),
                           ("qspa_qc_kernel(", 1)):
        body = src[src.index(kernel):]
        body = body[:body.index("\ntemplate <int Q, bool kLayered>")]
        assert f"PHASE_FLUSH({design})" in body
        marks = set(re.findall(r"PHASE(?:_AFTER)?\((kPh\w+)", body))
        assert {"kPhSetup", "kPhSyndrome", "kPhGather", "kPhSpectra",
                "kPhProducts", "kPhOutput", "kPhCnBarrier",
                "kPhExit"} <= marks


def test_phase_tool_refuses_a_changed_kernel():
    with pytest.raises(ValueError, match="Phase"):
        qspa_qc_phases.patched_source("// no kernel here\n")


def test_phase_tool_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("runs the measurement on a card")
    assert qspa_qc_phases.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err


def test_probe_mosaic_checks_cpu_calls_every_time():
    """The probe's once-checked fast path is for CUDA tensors only: a CPU
    call goes to the plain version and is never cached, and a bad shape is
    refused on every call."""
    x = torch.from_numpy(probe_mosaic.tile())
    for _ in range(2):
        assert torch.equal(probe_mosaic.compute("roll2", x),
                           torch.roll(x, 37, dims=2))
        with pytest.raises(ValueError, match="extra input"):
            probe_mosaic.compute("roll2", x, x[:1, :1])
    assert "roll2" not in probe_mosaic._FAST
