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

from cuda_ldpc_tpu import config as cfg
from cuda_ldpc_tpu import sim as jax_sim
from cuda_ldpc_tpu.parallel import get_mesh
from cuda_ldpc_tpu.utils import stats as jax_stats
from cuda_ldpc_torch import cli, sim
from cuda_ldpc_torch.ops import minsum
from cuda_ldpc_torch.utils import device, stats

REPO = pathlib.Path(__file__).resolve().parents[1]
COUNTERS = ["snr", "frames", "error_frames", "error_units", "iter_sum",
            "false_frames", "alarm_frames", "fer", "ber", "avg_iters"]


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


def _ref_cfg():
    return cfg.BinarySimConfig(
        code="J4_L24_Z96",
        decoder=cfg.BinaryDecoderConfig(max_iters=20, check="zero"),
        sweep=cfg.SweepConfig(snr_start=3.0, snr_step=0.6, snr_stop=3.6,
                              snr_type="ebn0", least_error_frames=5,
                              least_test_frames=128, max_frames=256,
                              display_step=10**6, seed=7),
        batch_per_device=64, channel="reference")


def test_reference_channel_sweep_rows_match_jax():
    """The slice as a whole: reference-LCG noise -> flooding min-sum ->
    counters -> stop rule -> rows, against the JAX package on one device."""
    ours = sim.run_binary_sweep(_ref_cfg(), device="cpu", quiet=True)
    theirs = jax_sim.run_binary_sweep(_ref_cfg(),
                                      mesh=get_mesh(jax.devices()[:1]),
                                      quiet=True)
    assert len(ours.rows) == 2
    assert _counters(ours.rows) == _counters(theirs.rows)
    assert ours.rows[0]["error_frames"] > 0      # the rows carry errors


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
    with pytest.raises(ValueError, match="CUDA"):
        sim._pick_binary_decode(cfg.BinaryDecoderConfig(kernel="cuda"), cpu)
    with pytest.raises(ValueError, match="kernel"):
        sim._pick_binary_decode(cfg.BinaryDecoderConfig(kernel="pallas"), cpu)


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


@pytest.mark.parametrize("argv", [
    ["--rule", "bp"], ["--schedule", "layered"], ["--packed"],
    ["--engine", "stream"], ["--tx", "random"], ["--profile", "trace"],
])
def test_cli_rejects_unported_options(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["binary", "--device", "cpu", *argv])
    assert exc.value.code != 0
    assert "ROADMAP.md" in capsys.readouterr().err


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


def test_port_imports_no_jax(tmp_path):
    proc = _run(["-c", "import sys, cuda_ldpc_torch, cuda_ldpc_torch.sim, "
                       "cuda_ldpc_torch.cli, cuda_ldpc_torch.ops.cuda_minsum; "
                       "print('jax' in sys.modules)"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"
