"""The port's sweep loop, binary batch engine and CLI, on the CPU, held
against the JAX package: under the reference-LCG channel both packages see
the same noise, so every counter of every row must be identical."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

from cuda_ldpc_tpu import config as jax_cfg
from cuda_ldpc_tpu import sim as jax_sim
from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode as JaxCode
from cuda_ldpc_tpu.parallel import get_mesh
from cuda_ldpc_tpu.utils import stats as jax_stats
from cuda_ldpc_torch import QCBinaryCode, cli, sim
from cuda_ldpc_torch import config as cfg
from cuda_ldpc_torch.ops import channel, cuda_minsum, minsum
from cuda_ldpc_torch.utils import device, stats

REPO = pathlib.Path(__file__).resolve().parents[1]
COUNTERS = ["snr", "frames", "error_frames", "error_units", "iter_sum",
            "false_frames", "alarm_frames", "fer", "ber", "avg_iters"]

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from torch's thread pool, and its spinning
    threads slow the other test workers sharing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _counters(rows):
    return [{k: r[k] for k in COUNTERS} for r in rows]


@pytest.mark.parametrize("kind", ["binary", "nb"])
def test_snr_stats_rows_match_jax(kind):
    kw = dict(snr=3.6, frames=2021, error_frames=33, error_units=1234,
              iter_sum=101050, false_frames=1, alarm_frames=2, decode_s=0.25,
              info_bits=2021 * 1920, units_per_frame=1920, timed_frames=1900)
    a, b = jax_sim.SnrStats(**kw), sim.SnrStats(**kw)
    assert a.row(kind) == b.row(kind)
    assert a.to_dict(kind) == b.to_dict(kind)


def _ref_cfg(c=cfg, **decoder):
    """The reference-channel sweep, as config module ``c`` (the port's or
    the JAX package's) spells it."""
    return c.BinarySimConfig(
        code="J4_L24_Z96",
        decoder=c.BinaryDecoderConfig(max_iters=20, check="zero", **decoder),
        sweep=c.SweepConfig(snr_start=3.0, snr_step=0.6, snr_stop=3.6,
                            snr_type="ebn0", least_error_frames=5,
                            least_test_frames=128, max_frames=256,
                            display_step=10**6, seed=7),
        batch_per_device=64, channel="reference")


def test_reference_channel_sweep_rows_match_jax():
    """The slice as a whole: reference-LCG noise -> flooding min-sum ->
    counters -> stop rule -> rows, against the JAX package on one device."""
    ours = sim.run_binary_sweep(_ref_cfg(), device="cpu", quiet=True)
    theirs = jax_sim.run_binary_sweep(_ref_cfg(jax_cfg),
                                      mesh=get_mesh(jax.devices()[:1]),
                                      quiet=True)
    assert len(ours.rows) == 2
    assert _counters(ours.rows) == _counters(theirs.rows)
    assert ours.rows[0]["error_frames"] > 0      # the rows carry errors


def test_layered_reference_channel_sweep_rows_match_jax():
    """The same sweep through the layered schedule: every counter of every
    row equal to the JAX package's."""
    ours = sim.run_binary_sweep(_ref_cfg(schedule="layered"), device="cpu",
                                quiet=True)
    theirs = jax_sim.run_binary_sweep(_ref_cfg(jax_cfg, schedule="layered"),
                                      mesh=get_mesh(jax.devices()[:1]),
                                      quiet=True)
    assert len(ours.rows) == 2
    assert _counters(ours.rows) == _counters(theirs.rows)
    assert ours.rows[0]["error_frames"] > 0


def test_both_packages_refuse_bp_on_the_reference_channel():
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    with pytest.raises(ValueError, match="bp"):
        sim.run_binary_sweep(_ref_cfg(rule="bp"), device="cpu", quiet=True)
    with pytest.raises(ValueError, match="bp"):
        sim.make_binary_ref_channel_step(code, _ref_cfg(rule="bp"),
                                         torch.device("cpu"))
    with pytest.raises(ValueError, match="bp"):
        jax_sim.make_binary_ref_channel_step(
            JaxCode.from_registry("J4_L24_Z96"), _ref_cfg(jax_cfg, rule="bp"),
            mesh=get_mesh(jax.devices()[:1]))


@pytest.mark.parametrize("rule", ["minsum", "bp"])
def test_binary_step_scales_bp_to_true_llrs(monkeypatch, rule):
    """The step hands the decoder the channel samples for min-sum and
    2y/sigma^2 for bp, with the rule, as the JAX package's step does."""
    seen = {}

    def fake_decode(chan, code, num_iters, **kw):
        seen["chan"], seen["kw"] = chan.clone(), kw
        return minsum.decode_flooding(chan, code, 0)

    monkeypatch.setattr(sim, "_pick_binary_decode", lambda dec, dev:
                        fake_decode)
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    simcfg = cfg.BinarySimConfig(code=code.name, batch_per_device=3,
                                 decoder=cfg.BinaryDecoderConfig(rule=rule))
    step, B = sim.make_binary_step(code, simcfg, torch.device("cpu"))
    sigma = 0.7
    step(torch.Generator().manual_seed(5), sigma)
    y = channel.bpsk_awgn_llr(torch.Generator().manual_seed(5),
                              torch.zeros(code.L, code.Z), sigma, B)
    want = y * (2.0 / (sigma * sigma)) if rule == "bp" else y
    assert torch.equal(seen["chan"], want)
    assert seen["kw"]["rule"] == rule


def _kill_cfg(channel):
    # the stop rule is frames only, so the kill point cannot fall on the one
    # batch where a pipelined resume would decide the rule one batch earlier
    return cfg.BinarySimConfig(
        code="J4_L24_Z96",
        decoder=cfg.BinaryDecoderConfig(max_iters=6, check="zero"),
        sweep=cfg.SweepConfig(snr_start=3.0, snr_step=0.6, snr_stop=3.6,
                              snr_type="ebn0", least_error_frames=10**6,
                              least_test_frames=0, max_frames=96,
                              display_step=10**6, seed=3),
        batch_per_device=16, channel=channel)


class _Killed(Exception):
    pass


@pytest.mark.parametrize("channel", ["device", "reference"])
def test_checkpoint_kill_and_resume_gives_same_rows(tmp_path, monkeypatch,
                                                    channel):
    full = sim.run_binary_sweep(_kill_cfg(channel), device="cpu", quiet=True)
    real_save = sim._Checkpoint.save
    saves = []

    def save_then_die(self, stats, *args):
        real_save(self, stats, *args)
        if stats is not None:
            saves.append(stats.frames)
            if len(saves) == 10:          # mid-way through the second point
                raise _Killed

    ck = str(tmp_path / "ck.json")
    monkeypatch.setattr(sim._Checkpoint, "save", save_then_die)
    with pytest.raises(_Killed):
        sim.run_binary_sweep(_kill_cfg(channel), device="cpu", checkpoint=ck,
                             quiet=True)
    monkeypatch.undo()
    resumed = sim.run_binary_sweep(_kill_cfg(channel), device="cpu",
                                   checkpoint=ck, quiet=True)
    assert _counters(resumed.rows) == _counters(full.rows)


def test_device_channel_seeds():
    seeds = {sim.batch_seed(173, si, bi) for si in range(4) for bi in range(50)}
    assert len(seeds) == 200
    assert sim.batch_seed(173, 2, 7) == sim.batch_seed(173, 2, 7)
    assert all(0 <= s < 2**63 for s in seeds)


def test_pick_binary_decode():
    cpu = torch.device("cpu")
    for kernel in ("auto", "torch"):
        dec = cfg.BinaryDecoderConfig(kernel=kernel)
        assert sim._pick_binary_decode(dec, cpu) is minsum.decode_flooding
        dec = cfg.BinaryDecoderConfig(kernel=kernel, schedule="layered")
        assert sim._pick_binary_decode(dec, cpu) is minsum.decode_layered
    cuda = torch.device("cuda", 0)        # dispatch only, nothing launched
    for schedule in ("flooding", "layered"):
        dec = cfg.BinaryDecoderConfig(schedule=schedule)
        assert (sim._pick_binary_decode(dec, cuda)
                is getattr(cuda_minsum, f"decode_{schedule}"))
    with pytest.raises(ValueError, match="CUDA"):
        sim._pick_binary_decode(cfg.BinaryDecoderConfig(kernel="cuda"), cpu)
    with pytest.raises(ValueError, match="kernel"):
        sim._pick_binary_decode(cfg.BinaryDecoderConfig(kernel="pallas"), cpu)
    with pytest.raises(ValueError, match="schedule"):
        sim._pick_binary_decode(cfg.BinaryDecoderConfig(schedule="shuffled"),
                                cpu)


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("errors,frames", [(5, 100), (0, 100), (33, 2021),
                                           (100, 100)])
def test_clopper_pearson_matches_jax(errors, frames):
    ours = stats.clopper_pearson(errors, frames, 0.95)
    theirs = jax_stats.clopper_pearson(errors, frames, 0.95)
    # the JAX version bisects on a float32 betainc (x64 off), which places
    # the bound to about 1e-4 of its value; scipy's quantile is float64
    assert ours == pytest.approx(theirs, rel=5e-4, abs=1e-7)
    assert stats.rates_compatible(33, 2021, 36, 2021)
    assert not stats.rates_compatible(51, 38912, 304, 4096)


@pytest.mark.parametrize("argv", [["--packed", "--profile", "trace"]])
def test_cli_rejects_unported_options(argv, capsys):
    """--profile, which traces a batch of the batch engine, is refused with
    --packed.  (--msg-dtype bfloat16 runs: tests/test_torch_minsum_bf16.py
    holds it, and its refusal on the stream engine, by design.)"""
    with pytest.raises(SystemExit) as exc:
        cli.main(["binary", "--device", "cpu", *argv])
    assert exc.value.code != 0
    assert "batch engine" in capsys.readouterr().err


@pytest.mark.parametrize("argv,refused", [
    (["--rule", "bp", "--packed", "--tx", "random", "--check", "syndrome"],
     None),
    (["--engine", "stream", "--tx", "random", "--check", "syndrome"], None),
    (["--tx", "random", "--check", "syndrome"], None),
    (["--engine", "stream", "--tx", "random"], "needs check='syndrome'"),
    (["--tx", "random", "--check", "syndrome", "--channel", "reference"],
     "channel='reference'"),
])
def test_cli_tx_random(tmp_path, argv, refused, capsys):
    """--tx random runs on the CPU with the syndrome check, on the batch,
    packed and stream engines; with the zero check (the default), and with
    the reference channel, whose noise is the all-zero word's, it is
    refused with a message."""
    out = tmp_path / "res"
    run = ["binary", "--device", "cpu", "--code", "J4_L24_Z96", "--batch",
           "16", "--max-iters", "8", "--snr", "3.6", "--snr-type", "ebn0",
           "--least-error-frames", "1", "--least-test-frames", "16",
           "--max-frames", "32", "--stream-steps", "3", "--out-dir",
           str(out), "--quiet", *argv]
    if refused:
        with pytest.raises(SystemExit) as exc:
            cli.main(run)
        assert exc.value.code == 2
        assert refused in capsys.readouterr().err
        assert not out.exists()
        return
    assert cli.main(run) == 0
    rows = [json.loads(x) for x in
            (out / "results.jsonl").read_text().splitlines()]
    assert rows[-1]["frames"] >= 16 and 0.0 <= rows[-1]["fer"] < 1.0
    assert " tx: random" in (out / "results.txt").read_text()


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_binary_on_cpu_writes_results(tmp_path):
    out = tmp_path / "res"
    proc = _run(["-m", "cuda_ldpc_torch", "binary", "--device", "cpu",
                 "--code", "J4_L24_Z96", "--batch", "16", "--max-iters", "5",
                 "--snr", "3:0.6:3.6", "--snr-type", "ebn0",
                 "--least-error-frames", "1", "--least-test-frames", "16",
                 "--max-frames", "32", "--out-dir", str(out), "--quiet"],
                tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = (out / "results.txt").read_text().strip().splitlines()
    # SNR frames errF FER BER avgIT FER_False FER_Alarm
    assert len(lines[-1].split()) == 8
    rows = [json.loads(x) for x in
            (out / "results.jsonl").read_text().splitlines()]
    assert [r["snr"] for r in rows] == [3.0, 3.6]
    assert all(r["kind"] == "binary" and r["frames"] >= 16 for r in rows)


@pytest.mark.parametrize("argv", [["--schedule", "layered"],
                                  ["--rule", "bp"],
                                  ["--rule", "bp", "--schedule", "layered"]])
def test_cli_runs_layered_and_bp_on_cpu(tmp_path, argv):
    out = tmp_path / "res"
    assert cli.main(["binary", "--device", "cpu", "--code", "J4_L24_Z96",
                     "--batch", "16", "--max-iters", "5", "--snr", "3.6",
                     "--snr-type", "ebn0", "--least-error-frames", "1",
                     "--least-test-frames", "16", "--max-frames", "32",
                     "--out-dir", str(out), "--quiet", *argv]) == 0
    text = (out / "results.txt").read_text()
    assert ("layered" in text) == ("layered" in argv)
    assert ("sum-product" in text) == ("bp" in argv)
    rows = [json.loads(x) for x in
            (out / "results.jsonl").read_text().splitlines()]
    assert [r["snr"] for r in rows] == [3.6] and rows[0]["frames"] >= 16


def test_port_imports_no_jax(tmp_path):
    proc = _run(["-c", "import sys, cuda_ldpc_torch, cuda_ldpc_torch.sim, "
                       "cuda_ldpc_torch.cli, cuda_ldpc_torch.ops.cuda_minsum; "
                       "print('jax' in sys.modules)"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"
