"""The port's own host layer (cuda_ldpc_torch.models, .utils.registry/io/
lcg/native, .config, the CLI's helpers) against the JAX package's, whose
copy it is, and the rule that the port imports nothing of JAX or of the JAX
package.  Tolerance: none — these are integer tables, dataclass defaults and
bit-exact host arithmetic."""

import argparse
import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from cuda_ldpc_tpu import cli as jax_cli
from cuda_ldpc_tpu import config as jax_cfg
from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode as JaxCode
from cuda_ldpc_tpu.utils import lcg as jax_lcg
from cuda_ldpc_tpu.utils import native as jax_native
from cuda_ldpc_tpu.utils import registry as jax_registry
from cuda_ldpc_torch import cli, config
from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
from cuda_ldpc_torch.utils import io, lcg, native, registry

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cuda_ldpc_torch"


@pytest.mark.parametrize("name", jax_registry.BINARY_CODES)
def test_codes_match_jax(name):
    ours, theirs = QCBinaryCode.from_registry(name), JaxCode.from_registry(name)
    np.testing.assert_array_equal(ours.base, theirs.base)
    np.testing.assert_array_equal(ours.edges, theirs.edges)
    for a, b in [(ours.row_edges, theirs.row_edges),
                 (ours.col_edges, theirs.col_edges)]:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(ours.row_weights, theirs.row_weights)
    assert (ours.Z, ours.n, ours.k, ours.m, ours.rate, ours.num_edges) == \
        (theirs.Z, theirs.n, theirs.k, theirs.m, theirs.rate, theirs.num_edges)
    assert repr(ours) == repr(theirs)


def test_code_from_base_and_dense_H():
    """The constructor the tests use to carry a code across, and the
    lifted matrix, on a hand-made code."""
    base = np.array([[0, 1, 2, -1], [3, -1, 0, 1]])
    ours = QCBinaryCode(name="tiny", base=base, Z=4)
    theirs = JaxCode(name="tiny", base=base, Z=4)
    np.testing.assert_array_equal(ours.dense_H, theirs.dense_H)
    with pytest.raises(ValueError, match="shifts"):
        QCBinaryCode(name="bad", base=np.array([[4]]), Z=4)


def test_registry_lists_and_asset_search(tmp_path, monkeypatch):
    """Both packages list the same codes and search the same places: a
    directory in CUDA_LDPC_TPU_ASSETS comes first, for npz and for text."""
    assert registry.BINARY_CODES == jax_registry.BINARY_CODES
    assert registry.NB_CODES == jax_registry.NB_CODES
    np.savez(tmp_path / "J4_L24_Z96.npz", base=np.array([[0, 1]]), Z=2)
    (tmp_path / "J2_L3_Z5_BlockH.txt").write_text("0 1 -1\n4 -1 2\n")
    monkeypatch.setenv("CUDA_LDPC_TPU_ASSETS", str(tmp_path))
    for name in ("J4_L24_Z96", "J2_L3_Z5"):
        ours, theirs = (registry.load_binary_base(name),
                        jax_registry.load_binary_base(name))
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1]
    assert registry.load_binary_base("J2_L3_Z5")[1] == 5
    with pytest.raises(FileNotFoundError):
        registry.load_binary_base("J9_L9_Z9")


def test_parse_blockh_rejects_what_jax_rejects(tmp_path):
    p = tmp_path / "J1_L2_Z3_BlockH.txt"
    p.write_text("0 3\n")
    with pytest.raises(ValueError, match="shifts"):
        io.parse_blockh(str(p))
    p.write_text("0 1 2\n")
    with pytest.raises(ValueError, match="entries"):
        io.parse_blockh(str(p))
    assert io.infer_blockh_dims("x/J15_L30_Z1280_BlockH.txt") == (15, 30, 1280)


@pytest.mark.parametrize("cls", ["SweepConfig", "BinaryDecoderConfig",
                                 "BinarySimConfig"])
def test_config_defaults_match_jax(cls):
    ours, theirs = getattr(config, cls)(), getattr(jax_cfg, cls)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    if cls == "SweepConfig":
        assert ours.snr_points() == theirs.snr_points()


def test_reference_lcg_matches_jax():
    a, b = lcg.ReferenceLCG(), jax_lcg.ReferenceLCG()
    np.testing.assert_array_equal(a.uniforms(3000), b.uniforms(3000))
    assert a.seed == b.seed
    cw = np.array([0, 1, 1, 0, 1], np.uint8)
    np.testing.assert_array_equal(
        lcg.awgn_binary(lcg.ReferenceLCG((5, 7, 11)), cw, 0.8, 3),
        jax_lcg.awgn_binary(jax_lcg.ReferenceLCG((5, 7, 11)), cw, 0.8, 3))


def test_native_channel_matches_jax_and_python():
    """The shared native library through both bridges, and the port's
    native and pure-Python paths, draw the same noise."""
    if not native.available():
        pytest.skip("native/libldpc_host.so cannot be loaded or built")
    cw = np.zeros(96, np.uint8)
    ours, seeds = native.awgn_binary(cw, 0.7, 4, (173, 173, 173))
    theirs, jax_seeds = jax_native.awgn_binary(cw, 0.7, 4, (173, 173, 173))
    np.testing.assert_array_equal(ours, theirs)
    assert seeds == jax_seeds
    gen = lcg.ReferenceLCG()
    np.testing.assert_allclose(lcg.awgn_binary(gen, cw, 0.7, 4), ours,
                               rtol=0, atol=1e-12)
    assert tuple(gen.seed) == seeds


@pytest.mark.parametrize("spec", ["3.6", "0:0.2:13", "-1.6:0.1:-1.4", "1:2",
                                  "a:b:c", ""])
def test_parse_snr_matches_jax(spec):
    try:
        theirs = jax_cli._parse_snr(spec)
    except argparse.ArgumentTypeError:
        with pytest.raises(argparse.ArgumentTypeError):
            cli._parse_snr(spec)
        return
    assert cli._parse_snr(spec) == theirs


def test_sweep_from_matches_jax():
    argv = ["binary", "--snr=-1.6:0.1:-1.4", "--snr-type", "esn0",
            "--least-error-frames", "7", "--seed", "5"]
    ours = cli._sweep_from(cli.build_parser().parse_args(argv),
                           config.BinarySimConfig().sweep)
    theirs = jax_cli._sweep_from(jax_cli.build_parser().parse_args(argv),
                                 jax_cfg.BinarySimConfig().sweep)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_list_codes_matches_jax(capsys):
    assert cli.main(["list-codes"]) == 0
    ours = capsys.readouterr().out
    assert jax_cli.main(["list-codes"]) == 0
    assert ours == capsys.readouterr().out


def _port_modules() -> list[str]:
    """Every module of the port but __main__, which runs the CLI."""
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py")
                  if p.name != "__main__.py")


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Every module of the port, imported in a fresh interpreter, loads no
    jax and no cuda_ldpc_tpu module."""
    mods = _port_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cuda_ldpc_tpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    assert {"cuda_ldpc_torch.ops.cuda_minsum", "cuda_ldpc_torch.ops.cuda_qspa",
            "cuda_ldpc_torch.ops.cuda_qspa_qc", "cuda_ldpc_torch.ops.nb_decode",
            "cuda_ldpc_torch.ops.demod", "cuda_ldpc_torch.models.nb_code",
            "cuda_ldpc_torch.utils.gf",
            "cuda_ldpc_torch.utils.constellations",
            "cuda_ldpc_torch.ops.minsum_stream",
            "cuda_ldpc_torch.ops.qspa_stream",
            "cuda_ldpc_torch.ops.cuda_minsum_stream",
            "cuda_ldpc_torch.ops.cuda_qspa_stream",
            "cuda_ldpc_torch.bench", "cuda_ldpc_torch.tools",
            "cuda_ldpc_torch.tools.profile_phases",
            "cuda_ldpc_torch.tools.probe_bitops",
            "cuda_ldpc_torch.tools.probe_mosaic",
            "cuda_ldpc_torch.tools.probe_oprate"} <= set(mods)


@pytest.mark.parametrize("path", ["chip_smoke.py", "cuda_ldpc_torch"])
def test_no_import_statement_names_jax_or_the_jax_package(path):
    """An AST scan of every import, including those inside functions, of
    chip_smoke.py and of the port's sources."""
    target = REPO / path
    files = [target] if target.is_file() else sorted(target.rglob("*.py"))
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib",
                                               "cuda_ldpc_tpu"), (f, n)
