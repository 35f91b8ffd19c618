"""The port's GF(q) batch engine and ``nb`` CLI on the CPU: the counters of
a batch against the JAX package's formula (sim.py:1253-1265) on the JAX
decoder's output for the same numpy LLRs (exact: integer counts of frames
whose decisions agree, see test_torch_nb_decode.py), the dispatch table,
the sweep loop, a tiny CPU sweep of every max-domain method, and the
refusals of what the port does not run yet."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu.ops import nb_decode as jax_nb
from cuda_ldpc_torch import cli, sim
from cuda_ldpc_torch import config as cfg
from cuda_ldpc_torch.ops import (cuda_nbms, cuda_qspa, cuda_qspa_qc, demod,
                                 nb_decode)
from cuda_ldpc_torch.utils import registry

from test_torch_nb_decode import codes
from test_torch_nb_maxdomain_codes import rows_in_order


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_counters(res, tx):
    """The JAX package's step epilogue (sim.py:1257-1265), on its own
    decoder's output."""
    errsyms = jnp.sum((res.hard != tx).astype(jnp.int32), axis=1)
    has_err = errsyms > 0
    false_f = has_err & res.ok
    alarm_f = ~has_err & ~res.ok
    return [int(x) for x in jnp.stack([
        jnp.sum(errsyms), jnp.sum(has_err.astype(jnp.int32)),
        jnp.sum(false_f.astype(jnp.int32)), jnp.sum(alarm_f.astype(jnp.int32)),
        jnp.sum(res.iters).astype(jnp.int32)])]


@pytest.mark.parametrize("tx", ["zero", "fixture"])
def test_counters_of_a_batch_match_jax(tx):
    """The slice as a whole on one batch: numpy channel samples of the
    transmitted codeword -> symbol LLRs -> the port's decode and counters,
    against the JAX decoder and the JAX formula on the same LLRs."""
    code, jax_code = codes("BDS.576.288.GF.64")
    syms = (registry.load_test_codeword(code.n_sym) if tx == "fixture"
            else np.zeros(code.n_sym, dtype=np.int64))
    bits = demod.sym_to_bit(syms, code.q_bit).reshape(code.n_sym, code.q_bit)
    rng = np.random.default_rng(11)
    sigma = 0.86
    y = (1.0 - 2.0 * bits) + sigma * rng.normal(size=(8,) + bits.shape)
    L = demod.llr_bpsk(torch.tensor(y, dtype=torch.float32), sigma, code.q)
    txt = torch.as_tensor(syms, dtype=torch.int32)
    ours = sim._nb_counters(nb_decode.decode(L, code, "qspa", 10), txt)
    theirs = jax_counters(jax_nb.decode(jnp.asarray(L.numpy()), jax_code,
                                        "qspa", 10), jnp.asarray(syms))
    assert ours.tolist() == theirs
    assert 0 < theirs[1] < 8              # some frames fail, some succeed


def _pick(code, method, kernel="auto", device=torch.device("cuda", 0),
          nm=2, nc=2):
    """The dispatch's choice; on a card nothing runs."""
    dec = cfg.NBDecoderConfig(method=method, kernel=kernel, max_iters=7,
                              nm=nm, nc=nc)
    return sim._nb_decoder_fn(code, dec, device)


def test_nb_dispatch():
    """auto on a card: K5 for qspa, layered_qspa and glayered_qspa on the
    adjacency codes, K6 for qspa and glayered_qspa on the QC code and for
    layered_qspa where its row groups are its block rows in order (the
    same function there), an error for the pairs with no kernel (a GF(16)
    code whose rows are not in QC order); torch: the plain version; cuda
    on the CPU: an error."""
    bds, _ = codes("BDS.576.288.GF.64")
    tanner = sim.NBCode.from_registry("Tanner_74_9_Z128_GF16")
    shuffled = rows_in_order(tanner, np.random.default_rng(0).permutation(
        tanner.m_sym))
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    pick = _pick

    for code, method, fn in [
            (bds, "qspa", cuda_qspa.decode_flooding),
            (bds, "layered_qspa", cuda_qspa.decode_layered),
            (bds, "glayered_qspa", cuda_qspa.decode_glayered),
            (tanner, "qspa", cuda_qspa_qc.decode_flooding),
            (tanner, "glayered_qspa", cuda_qspa_qc.decode_layered),
            (tanner, "layered_qspa", cuda_qspa_qc.decode_layered)]:
        for kernel in ("auto", "cuda"):
            f = pick(code, method, kernel)
            assert f.func is fn and f.keywords == {"code": code,
                                                   "max_iters": 7}
    for code, method in [(shuffled, "qspa"), (shuffled, "layered_qspa")]:
        for kernel in ("auto", "cuda"):
            with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 13"):
                pick(code, method, kernel)
        for device in (card, cpu):
            f = pick(code, method, "torch", device)
            assert f.func is nb_decode.decode and f.keywords["method"] == method
    assert pick(bds, "qspa", "auto", cpu).func is nb_decode.decode
    with pytest.raises(ValueError, match="CUDA"):
        pick(bds, "qspa", "cuda", cpu)
    with pytest.raises(ValueError, match="kernel"):
        pick(bds, "qspa", "pallas", cpu)


K8_DISPATCH = [
    # code, method, (nm, nc), what auto/cuda on a card takes
    ("BDS.576.288.GF.64", "ems", (2, 2), cuda_nbms.decode_ems),
    ("BDS.576.288.GF.64", "tmm", (2, 2), cuda_nbms.decode_tmm),
    ("BDS.576.288.GF.64", "layered_tmm", (2, 2),
     cuda_nbms.decode_layered_tmm),
    ("LDPC_N576_K288_GF64_d1_exp", "ems", (2, 2), cuda_nbms.decode_ems),
    ("LDPC_N576_K480_GF256_exp", "layered_tmm", (2, 2),
     cuda_nbms.decode_layered_tmm),
    ("LDPC_N576_K480_GF256_exp", "tmm", (3, 3), cuda_nbms.decode_tmm),
    ("BDS.576.288.GF.64", "ems", (3, 2), cuda_nbms.decode_ems),
    ("BDS.576.288.GF.64", "ems", (64, 3), cuda_nbms.decode_ems),
    ("LDPC_N576_K288_GF64_d1_exp", "ems", (1, 2), cuda_nbms.decode_ems),
    ("LDPC_N576_K480_GF256_exp", "ems", (8, 10), cuda_nbms.decode_ems),
    ("LDPC_N96_K48_GF256_d1_exp", "ems", (257, 3), cuda_nbms.decode_ems),
    ("BDS.576.288.GF.64", "ems_full", (2, 2), cuda_nbms.decode_ems_full),
    ("LDPC_N576_K480_GF256_exp", "ems_full", (3, 3),
     cuda_nbms.decode_ems_full),
    ("BDS.576.288.GF.64", "glayered_tmm", (2, 2),
     cuda_nbms.decode_glayered_tmm),
    ("LDPC_N576_K480_GF256_exp", "glayered_tmm", (2, 2),
     cuda_nbms.decode_glayered_tmm),
    ("Tanner_74_9_Z128_GF16", "glayered_tmm", (2, 2), None),
    ("Tanner_74_9_Z128_GF16", "ems", (2, 2), None),
    ("Tanner_74_9_Z128_GF16", "ems", (4, 2), None),
    ("Tanner_74_9_Z128_GF16", "layered_tmm", (2, 2), None),
    ("Tanner_74_9_Z128_GF16", "ems_full", (2, 2), None),
]


@pytest.mark.parametrize("name,method,nmnc,fn", K8_DISPATCH,
                         ids=[f"{c[0]}-{c[1]}-{c[2][0]}{c[2][1]}"
                              for c in K8_DISPATCH])
def test_nb_dispatch_max_domain(name, method, nmnc, fn):
    """The max-domain methods: K8 where it takes the pair, EMS with its
    Nm/Nc (which matter to EMS only), else an error naming ROADMAP.md
    Queue 1 item 19 under auto and cuda on a card; the plain version, with
    Nm/Nc, under torch and under auto on the CPU; cuda on the CPU
    raises."""
    code = sim.NBCode.from_registry(name)
    cpu = torch.device("cpu")
    for kernel in ("auto", "cuda"):
        if fn is None:
            with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 19"):
                _pick(code, method, kernel, nm=nmnc[0], nc=nmnc[1])
        else:
            f = _pick(code, method, kernel, nm=nmnc[0], nc=nmnc[1])
            want = {"code": code, "max_iters": 7}
            if method == "ems":
                want.update(nm=nmnc[0], nc=nmnc[1])
            assert f.func is fn and f.keywords == want
    for kernel, device in [("torch", torch.device("cuda", 0)),
                           ("torch", cpu), ("auto", cpu)]:
        f = _pick(code, method, kernel, device, nm=nmnc[0], nc=nmnc[1])
        assert f.func is nb_decode.decode
        assert f.keywords == {"code": code, "method": method, "max_iters": 7,
                              "nm": nmnc[0], "nc": nmnc[1]}
    with pytest.raises(ValueError, match="CUDA"):
        _pick(code, method, "cuda", cpu)


def test_nb_dispatch_refuses_an_ems_the_plain_version_refuses():
    """An EMS Nm/Nc the plain version (and the JAX package) refuses raises
    its own error under every kernel choice, on a card before any kernel
    is chosen."""
    bds, _ = codes("BDS.576.288.GF.64")
    for kernel in ("auto", "cuda"):
        with pytest.raises(ValueError, match="Nm - 1 <= q"):
            _pick(bds, "ems", kernel, nm=66, nc=2)
        with pytest.raises(ValueError, match="Nc >= 1"):
            _pick(bds, "ems", kernel, nm=2, nc=0)
    f = _pick(bds, "ems", "torch", torch.device("cpu"), nm=66, nc=2)
    with pytest.raises(ValueError, match="Nm - 1 <= q"):
        f(torch.zeros((1, bds.n_sym, bds.q)))


def test_nb_stream_max_domain_refused_on_a_card():
    """No stream kernel runs a max-domain method: auto on a card raises,
    naming ROADMAP.md Queue 1 item 20; an unknown method raises."""
    code, _ = codes("BDS.576.288.GF.64")
    for method in ("ems", "ems_full", "tmm", "layered_tmm", "glayered_tmm"):
        conf = _nb_cfg(code="BDS.576.288.GF.64", engine="stream",
                       decoder=cfg.NBDecoderConfig(method=method))
        with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 20"):
            sim.make_nb_stream_engine(code, conf, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="unknown NB decoder method"):
        sim.make_nb_step(code, _nb_cfg(decoder=cfg.NBDecoderConfig(
            method="bogus")), torch.device("cpu"))


@pytest.mark.parametrize("argv,item", [
    (["--method", "qspa", "--engine", "stream", "--profile", "trace"],
     "batch engine"),
])
def test_cli_nb_refuses_unported_options(argv, item, capsys):
    """Options not ported yet name their ROADMAP.md item; --profile, which
    traces a batch of the batch engine, is refused with --engine stream."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["nb", "--device", "cpu", *argv])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert item in err and ("ROADMAP.md" in err or "--profile" in argv)


@pytest.mark.parametrize("argv", [
    ["--method", "qspa", "--tx", "random"],
    ["--method", "qspa", "--packed", "--tx", "random"],
    ["--method", "layered_qspa", "--engine", "stream", "--packed", "--tx",
     "random", "--n-qam", "64", "--snr", "8"],
])
def test_cli_nb_tx_random(tmp_path, argv):
    """nb --tx random runs on the CPU: batch, packed and packed stream, BPSK
    and 64-QAM; near the waterfall most frames decode to their own
    codeword."""
    out = tmp_path / "res"
    assert cli.main(["nb", "--device", "cpu", "--code", "BDS.576.288.GF.64",
                     "--batch", "8", "--max-iters", "8", "--snr", "2.5",
                     "--least-error-frames", "1", "--least-test-frames", "8",
                     "--max-frames", "16", "--stream-steps", "3",
                     "--out-dir", str(out), "--quiet", *argv]) == 0
    rows = [json.loads(x) for x in
            (out / "results.jsonl").read_text().splitlines()]
    assert rows[-1]["frames"] >= 16 and 0.0 <= rows[-1]["fer"] < 0.5
    assert "tx: random" in (out / "results.txt").read_text()


@pytest.mark.parametrize("argv", [
    [],                                                # the default, ems
    ["--method", "ems_full"],
    ["--method", "tmm"],
    ["--method", "layered_tmm"],
    ["--method", "glayered_tmm", "--packed", "--snr", "4:1:5"],
    ["--method", "ems", "--nm", "3", "--engine", "stream"],
], ids=["ems", "ems_full", "tmm", "layered_tmm", "glayered_tmm-packed",
        "ems-nm3-stream"])
def test_cli_nb_runs_every_max_domain_method_on_cpu(tmp_path, argv, capsys):
    """A tiny CPU sweep of each max-domain method on BDS.576.288.GF.64
    (the plain engines), with the method and Nm/Nc in the banner."""
    out = tmp_path / "res"
    assert cli.main(["nb", "--device", "cpu", "--batch", "4", "--max-iters",
                     "3", "--least-test-frames", "4", "--max-frames", "4",
                     "--stream-steps", "2", "--snr", "4", "--out-dir",
                     str(out), *argv]) == 0
    banner = capsys.readouterr().out
    method = argv[1] if argv else "ems"
    assert f"decoder: {method}" in banner
    assert ("Nm=3, Nc=2" in banner) == ("--nm" in argv)
    rows = [json.loads(x) for x in
            (out / "results.jsonl").read_text().splitlines()]
    assert rows and all(r["kind"] == "nb" and r["frames"] >= 4 for r in rows)
    assert all(0.0 < r["avg_iters"] <= 3.0 for r in rows)


def _nb_cfg(**kw):
    base = dict(code="LDPC_N96_K48_GF256_d1_exp",
                decoder=cfg.NBDecoderConfig(method="layered_qspa",
                                            max_iters=6),
                sweep=cfg.SweepConfig(snr_start=2.0, snr_step=1.0,
                                      snr_stop=3.0, least_error_frames=10**6,
                                      least_test_frames=0, max_frames=48,
                                      display_step=10**6, seed=3),
                batch_per_device=16)
    base.update(kw)
    return cfg.NBSimConfig(**base)


class _Killed(Exception):
    pass


def test_nb_sweep_checkpoint_kill_and_resume(tmp_path, monkeypatch):
    full = sim.run_nb_sweep(_nb_cfg(), device="cpu", quiet=True)
    assert [r["snr"] for r in full.rows] == [2.0, 3.0]
    assert all(r["kind"] == "nb" and r["frames"] >= 48 for r in full.rows)
    real_save = sim._Checkpoint.save
    saves = []

    def save_then_die(self, stats, *args):
        real_save(self, stats, *args)
        if stats is not None:
            saves.append(stats.frames)
            if len(saves) == 5:           # in the second point
                raise _Killed

    ck = str(tmp_path / "ck.json")
    monkeypatch.setattr(sim._Checkpoint, "save", save_then_die)
    with pytest.raises(_Killed):
        sim.run_nb_sweep(_nb_cfg(), device="cpu", checkpoint=ck, quiet=True)
    monkeypatch.undo()
    resumed = sim.run_nb_sweep(_nb_cfg(), device="cpu", checkpoint=ck,
                               quiet=True)
    keys = ["snr", "frames", "error_frames", "error_units", "iter_sum",
            "false_frames", "alarm_frames"]
    assert ([{k: r[k] for k in keys} for r in resumed.rows]
            == [{k: r[k] for k in keys} for r in full.rows])


@pytest.mark.parametrize("argv", [
    ["--code", "BDS.576.288.GF.64", "--method", "qspa", "--snr", "1.5"],
    ["--code", "LDPC_N96_K48_GF256_d1_exp", "--method", "glayered_qspa",
     "--n-qam", "256", "--snr", "6"],
    ["--code", "BDS.576.288.GF.64", "--method", "layered_qspa", "--tx",
     "fixture", "--n-qam", "64", "--snr", "9"],
])
def test_cli_nb_on_cpu_writes_results(tmp_path, argv):
    out = tmp_path / "res"
    assert cli.main(["nb", "--device", "cpu", "--batch", "8", "--max-iters",
                     "8", "--least-test-frames", "8", "--max-frames", "16",
                     "--out-dir", str(out), "--quiet", *argv]) == 0
    text = (out / "results.txt").read_text()
    assert argv[3] in text and "sec/frame" in text
    rows = [json.loads(x) for x in
            (out / "results.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["kind"] == "nb"
    assert rows[0]["frames"] >= 16 and 0.0 <= rows[0]["fer"] < 1.0
    assert 0.0 < rows[0]["avg_iters"] <= 8.0


def test_qam_order_must_match_the_field():
    with pytest.raises(ValueError, match="QAM order"):
        sim.make_nb_step(codes("BDS.576.288.GF.64")[0],
                         _nb_cfg(code="BDS.576.288.GF.64", n_qam=256),
                         torch.device("cpu"))
