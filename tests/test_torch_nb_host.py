"""The port's GF(q) host layer (utils/gf, utils/constellations, the NB half
of utils/io and utils/registry, models/nb_code, the NB config dataclasses,
the kernels' plans) against the JAX package's, whose copy it is.
Tolerance: none — these are integer tables, exact float constants and
dataclass defaults.  Numpy only: nothing here compiles JAX."""

import dataclasses

import numpy as np
import pytest

from cuda_ldpc_tpu import config as jax_cfg
from cuda_ldpc_tpu.models.nb_code import NBCode as JaxNBCode
from cuda_ldpc_tpu.ops import pallas_qspa_qc
from cuda_ldpc_tpu.utils import constellations as jax_const
from cuda_ldpc_tpu.utils import gf as jax_gf
from cuda_ldpc_tpu.utils import io as jax_io
from cuda_ldpc_tpu.utils import registry as jax_registry
from cuda_ldpc_torch import NBCode, config
from cuda_ldpc_torch.ops import cuda_qspa, cuda_qspa_qc
from cuda_ldpc_torch.utils import constellations, gf, io, registry

from test_pallas_qspa_qc import synthetic_qc_code

NB_FIELDS = [f.name for f in dataclasses.fields(NBCode)]


def port_code(jax_code: JaxNBCode) -> NBCode:
    """The port's code built from the JAX code's padded arrays."""
    f = io.NBCodeFile(
        jax_code.n_sym, jax_code.m_sym, jax_code.q, jax_code.max_dv,
        jax_code.max_dc, jax_code.vn_weight, jax_code.cn_weight,
        np.where(jax_code.vn_mask, jax_code.vn_links, -1), jax_code.vn_gf,
        np.where(jax_code.cn_mask, jax_code.cn_links, -1), jax_code.cn_gf)
    return NBCode.from_file(f, name=jax_code.name)


def assert_same_code(ours: NBCode, theirs: JaxNBCode):
    for name in NB_FIELDS:
        a, b = getattr(ours, name), getattr(theirs, name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    for table in ("mul_table", "inv_table", "xor_table"):
        np.testing.assert_array_equal(getattr(ours, table),
                                      getattr(theirs, table))
    assert (ours.q_bit, ours.bit_length, ours.k_sym, ours.rate) == \
        (theirs.q_bit, theirs.bit_length, theirs.k_sym, theirs.rate)
    assert repr(ours) == repr(theirs)


@pytest.mark.parametrize("q", sorted(jax_gf.PRIMITIVE_POLY))
def test_gf_tables_match_jax(q):
    assert gf.PRIMITIVE_POLY[q] == jax_gf.PRIMITIVE_POLY[q]
    for a, b in zip(gf.exp_log_tables(q), jax_gf.exp_log_tables(q)):
        np.testing.assert_array_equal(a, b)
    for fn in ("mul_table", "inv_table", "xor_table"):
        np.testing.assert_array_equal(getattr(gf, fn)(q),
                                      getattr(jax_gf, fn)(q))


@pytest.mark.parametrize("n_qam", [2, 64, 256])
def test_constellations_match_jax(n_qam):
    np.testing.assert_array_equal(constellations.constellation(n_qam),
                                  jax_const.constellation(n_qam))


@pytest.mark.parametrize("name", jax_registry.NB_CODES)
def test_nb_codes_match_jax(name):
    """Every field and table of every shipped GF(q) code: from the registry,
    and built from the JAX code's arrays; and the syndrome of a random
    word."""
    theirs = JaxNBCode.from_registry(name)
    ours = NBCode.from_registry(name)
    assert_same_code(ours, theirs)
    assert_same_code(port_code(theirs), theirs)
    word = np.random.default_rng(1).integers(0, theirs.q, theirs.n_sym)
    np.testing.assert_array_equal(ours.syndrome(word), theirs.syndrome(word))
    a, b = registry.load_nb_code_file(name), jax_registry.load_nb_code_file(name)
    for field in dataclasses.fields(b):
        np.testing.assert_array_equal(getattr(a, field.name),
                                      getattr(b, field.name))


def test_parse_nb_code_matches_jax(tmp_path):
    """A two-VN, one-CN adjacency text file through both parsers."""
    p = tmp_path / "tiny.txt"
    p.write_text("2 1 4\n1 2\n1 1\n2\n1 3\n1 2\n1 3 2 2\n")
    a, b = io.parse_nb_code(str(p)), jax_io.parse_nb_code(str(p))
    for field in dataclasses.fields(b):
        np.testing.assert_array_equal(getattr(a, field.name),
                                      getattr(b, field.name))
    p.write_text("2 1 4\n1 2\n1 1\n2\n1 3\n")
    with pytest.raises(ValueError, match="truncated"):
        io.parse_nb_code(str(p))


def test_fixture_codeword_matches_jax(tmp_path, monkeypatch):
    """From assets/codeword_test_96.npz, and from a codeword_test.h in a
    CUDA_LDPC_TPU_ASSETS directory (its commented-out array skipped)."""
    ours = registry.load_test_codeword(96)
    np.testing.assert_array_equal(ours, jax_registry.load_test_codeword(96))
    assert ours.shape == (96,) and ours.any()
    (tmp_path / "codeword_test.h").write_text(
        "// int CodeWord_sym_test[3] = {9, 9, 9};\n"
        "int CodeWord_sym_test[4] = {1, 0, 3,\n 2};\n")
    monkeypatch.setenv("CUDA_LDPC_TPU_ASSETS", str(tmp_path))
    np.testing.assert_array_equal(registry.load_test_codeword(4), [1, 0, 3, 2])
    np.testing.assert_array_equal(jax_registry.load_test_codeword(4),
                                  [1, 0, 3, 2])
    with pytest.raises(ValueError, match="needs 5"):
        registry.load_test_codeword(5)


@pytest.mark.parametrize("cls", ["NBDecoderConfig", "NBSimConfig"])
def test_nb_config_defaults_match_jax(cls):
    ours, theirs = getattr(config, cls)(), getattr(jax_cfg, cls)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("which", ["tanner", "synthetic"])
def test_qc_plan_matches_jax(which):
    """The K6 plan's block structure equals pallas_qspa_qc.make_plan's, and
    the per-lane coefficients equal the h * sym[1] column of its syndrome
    table (sym[1] = alpha^0 = 1)."""
    theirs_code = (JaxNBCode.from_registry("Tanner_74_9_Z128_GF16")
                   if which == "tanner" else synthetic_qc_code())
    ours = cuda_qspa_qc.make_plan(port_code(theirs_code))
    theirs = pallas_qspa_qc.make_plan(theirs_code)
    assert (ours.NB, ours.MB, ours.Z, ours.q, ours.EB) == \
        (theirs.NB, theirs.MB, theirs.Z, theirs.q, theirs.EB)
    assert ours.row_edges == theirs.row_edges
    assert ours.col_edges == theirs.col_edges
    assert theirs.sym[1] == 1
    np.testing.assert_array_equal(ours.hz, theirs.hv[:, 1, 0, :])
    if which == "tanner":
        assert (ours.NB, ours.MB, ours.EB) == (74, 9, 185)


def test_kernel_tables_follow_the_plan():
    code = port_code(synthetic_qc_code())
    plan = cuda_qspa_qc.make_plan(code)
    t = cuda_qspa_qc.kernel_tables(plan)
    assert all(a.dtype == np.int32 for a in t)
    for r, row in enumerate(plan.row_edges):
        eids = list(range(t.blk_ptr[r], t.blk_ptr[r + 1]))
        assert eids == [eid for eid, _, _ in row]
        assert [t.blk_c[e] for e in eids] == [c for _, c, _ in row]
        assert [t.blk_s[e] for e in eids] == [s for _, _, s in row]
    for c, col in enumerate(plan.col_edges):
        assert list(t.col_eid[t.col_ptr[c]:t.col_ptr[c + 1]]) == \
            [eid for eid, _ in col]
    # every (check row, slot) of the code appears as a block edge lane
    for m in range(0, code.m_sym, 37):
        r, z = divmod(m, plan.Z)
        got = [(t.blk_c[e] * plan.Z + (z + t.blk_s[e]) % plan.Z,
                t.hz[e * plan.Z + z]) for e in range(t.blk_ptr[r],
                                                      t.blk_ptr[r + 1])]
        w = code.cn_weight[m]
        assert got == list(zip(code.cn_links[m, :w], code.cn_gf[m, :w]))


@pytest.mark.parametrize("name", jax_registry.NB_CODES)
def test_k5_plan_and_dispatch_support(name):
    """K5's edge lists hold each row's edges in slot order and each VN's
    edges in its slot order; K5 takes the four adjacency codes and K6 only
    the QC code."""
    code = NBCode.from_registry(name)
    plan = cuda_qspa.make_plan(code)
    mask = code.cn_mask
    np.testing.assert_array_equal(plan.edge_vn, code.cn_links[mask])
    np.testing.assert_array_equal(plan.edge_h, code.cn_gf[mask])
    np.testing.assert_array_equal(np.diff(plan.row_ptr), code.cn_weight)
    for n in range(0, code.n_sym, 7):
        es = plan.col_edge[plan.col_ptr[n]:plan.col_ptr[n + 1]]
        np.testing.assert_array_equal(plan.edge_vn[es], np.full(len(es), n))
        rows = np.searchsorted(plan.row_ptr, es, side="right") - 1
        np.testing.assert_array_equal(rows,
                                      code.vn_links[n, :code.vn_weight[n]])
    log, exp2 = cuda_qspa.gf_tables(code.q)
    mul = code.mul_table
    a, b = np.arange(1, code.q), np.arange(code.q - 1, 0, -1)
    np.testing.assert_array_equal(exp2[log[a] + log[b]], mul[a, b])
    tanner = name == "Tanner_74_9_Z128_GF16"
    assert cuda_qspa.supports(code) == (not tanner)
    assert cuda_qspa_qc.supports(code) == tanner
