"""The port's measuring path on the CPU: the bench (``python -m
cuda_ldpc_torch.bench``), ``--profile DIR`` on the batch engines of
``binary`` and ``nb``, and ``python -m
cuda_ldpc_torch.tools.profile_phases``, at small sizes (J4_L24_Z96, B=8;
BDS.576.288.GF.64, B=8).  The numbers they print on the CPU are no device
metrics; these tests check what is printed and written, that the traced
sweeps give the rows of untraced ones, and what is refused.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from cuda_ldpc_torch import bench, cli, config as cfg, sim
from cuda_ldpc_torch.tools import profile_phases

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = {"BENCH_DEVICE": "cpu", "BENCH_CODE": "J4_L24_Z96",
         "BENCH_BATCH": "8", "BENCH_REPS": "2"}
COUNTERS = ("snr", "frames", "error_frames", "error_units", "iter_sum",
            "false_frames", "alarm_frames")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors gain nothing from torch's thread pool, whose
    spinning threads slow the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_bench_prints_one_json_line_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), **SMALL)
    proc = subprocess.run([sys.executable, "-m", "cuda_ldpc_torch.bench"],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "binary_minsum_info_mbps_cpu"
    assert line["device"] == "cpu" and line["card"] is None
    assert (line["batch"], line["iters"], line["kernel"]) == (8, 10, "torch")
    assert line["value"] > 0 and line["unit"] == "Mb/s"


@pytest.mark.parametrize("switch,item", [("BENCH_DTYPE", "item 4"),
                                         ("BENCH_TILE", "item 17")])
def test_bench_refuses_what_is_not_ported(switch, item, monkeypatch, capsys):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv(switch, "bfloat16" if switch == "BENCH_DTYPE" else "8")
    assert bench.main() == 2
    captured = capsys.readouterr()
    assert captured.out == "" and item in captured.err


def test_bench_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run({"BENCH_CODE": "J4_L24_Z96"})
    with pytest.raises(ValueError, match="BENCH_KERNEL=cuda"):
        bench.run(dict(SMALL, BENCH_KERNEL="cuda"))


def test_bench_plain_layered_and_profiled(tmp_path):
    line = bench.run(dict(SMALL, BENCH_KERNEL="torch",
                          BENCH_SCHEDULE="layered", BENCH_ITERS="3",
                          BENCH_PROFILE=str(tmp_path / "prof")))
    assert (line["kernel"], line["schedule"], line["iters"]) == (
        "torch", "layered", 3)
    with open(line["trace"]) as f:
        assert json.load(f)["traceEvents"]


def test_profile_phases_on_cpu(tmp_path, capsys):
    assert profile_phases.main(["--device", "cpu", "--code", "J4_L24_Z96",
                                "--batch", "8", "--reps", "1", "--trace",
                                str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["device"] == "cpu" and row["card"] is None
    assert row["decoder"] == "plain flooding min-sum"
    for key in ("channel_ms", "decode_2_iters_ms", "decode_12_iters_ms",
                "decode_per_iter_ms", "decode_intercept_ms",
                "check_zero_per_iter_ms", "check_syndrome_per_iter_ms",
                "plain_vn_ms", "plain_cn_ms"):
        assert isinstance(row[key], float), key
    assert row["plain_batch"] == profile_phases.PLAIN_BATCH
    assert os.path.exists(row["trace"])


def _rows(out_dir):
    with open(os.path.join(out_dir, "results.jsonl")) as f:
        return [{k: json.loads(ln)[k] for k in COUNTERS} for ln in f]


@pytest.mark.parametrize("argv,points", [
    (["binary", "--code", "J4_L24_Z96", "--snr", "2:0.5:2.5", "--batch", "8",
      "--max-iters", "5",
      "--least-error-frames", "3", "--least-test-frames", "24",
      "--max-frames", "40"], ["binary_snr2", "binary_snr2.5"]),
    (["nb", "--code", "BDS.576.288.GF.64", "--method", "qspa", "--snr", "2",
      "--max-iters", "3", "--batch", "8", "--least-error-frames", "1",
      "--least-test-frames", "16", "--max-frames", "16"], ["nb_snr2"]),
])
def test_profile_traces_one_batch_a_point_with_the_same_rows(tmp_path, argv,
                                                              points):
    common = ["--device", "cpu", "--quiet"]
    assert cli.main(argv + common + ["--out-dir", str(tmp_path / "plain")]) \
        == 0
    assert cli.main(argv + common + ["--out-dir", str(tmp_path / "traced"),
                                     "--profile", str(tmp_path / "tr")]) == 0
    assert sorted(os.listdir(tmp_path / "tr")) == points
    for p in points:
        with open(tmp_path / "tr" / p / "trace.json") as f:
            events = json.load(f)["traceEvents"]
        # the traced batch sits in a span named after its point
        assert any(e.get("name") == p and e.get("ph") == "X" for e in events)
    assert _rows(tmp_path / "traced") == _rows(tmp_path / "plain")


def test_profile_is_refused_off_the_batch_engine():
    conf = cfg.BinarySimConfig(code="J4_L24_Z96", engine="stream")
    with pytest.raises(ValueError, match="batch engine"):
        sim.run_binary_sweep(conf, device="cpu", profile_dir="x", quiet=True)


@pytest.mark.parametrize("run,conf", [
    (sim.run_binary_sweep_packed, cfg.BinarySimConfig(code="J4_L24_Z96")),
    (sim.run_binary_stream_packed, cfg.BinarySimConfig(code="J4_L24_Z96",
                                                       engine="stream")),
    (sim.run_nb_sweep_packed, cfg.NBSimConfig()),
    (sim.run_nb_stream_packed, cfg.NBSimConfig(engine="stream")),
])
def test_packed_runners_refuse_profile(run, conf, tmp_path):
    """The packed runners refuse a trace before they build anything."""
    with pytest.raises(ValueError, match="the packed engine has none"):
        run(conf, device="cpu", profile_dir=str(tmp_path), quiet=True)
    assert not os.listdir(tmp_path)


def test_profile_phases_protocol_needs_a_card():
    """--protocol times the kernels' launches: refused on the CPU."""
    with pytest.raises(ValueError, match="needs a card"):
        profile_phases.main(["--protocol", "--device", "cpu"])
