"""The port's packed and stream sweep engines (cuda_ldpc_torch.sim), binary
and GF(q), on the CPU.

* Exact accounting with the noise off: every frame passes its check at
  its first decide, so each call counts a known number of frames with no
  error and no iteration, in the port and in the JAX package.
* Statistics: stream, packed and packed-stream FERs are compatible
  (Clopper-Pearson, utils/stats.rates_compatible) with the batch engine's
  at the same point.
* Kill and resume: a stream sweep and a packed stream sweep stopped
  mid-way and resumed from their checkpoint give the uninterrupted run's
  rows exactly; a finished sweep run again returns its checkpointed rows.
* The kernel engine (per-call refill, K4 / K7 on a card) runs here with the
  plain stream steps, which the wrappers take for CPU tensors.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu import config as jax_cfg
from cuda_ldpc_tpu import sim as jax_sim
from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode as JaxCode
from cuda_ldpc_torch import NBCode, QCBinaryCode, cli, sim
from cuda_ldpc_torch import config as cfg
from cuda_ldpc_torch.ops import cuda_qspa_stream
from cuda_ldpc_torch.utils import stats

CPU = torch.device("cpu")
KEYS = ["snr", "frames", "error_frames", "error_units", "iter_sum",
        "false_frames", "alarm_frames"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(params=["plain", "kernel"])
def engine_kind(request, monkeypatch):
    """The plain per-iteration engine, or the kernel engine with per-call
    refill driven by the plain stream steps."""
    if request.param == "kernel":
        monkeypatch.setattr(sim, "_stream_uses_kernel",
                            lambda kernel, device: True)
    return request.param


def _counters(rows):
    return [{k: r[k] for k in KEYS} for r in rows]


def _bin_cfg(**kw):
    base = dict(code="J4_L24_Z96",
                decoder=cfg.BinaryDecoderConfig(max_iters=10),
                sweep=cfg.SweepConfig(snr_start=3.6, snr_step=0.4,
                                      snr_stop=3.6, snr_type="ebn0",
                                      least_error_frames=20,
                                      least_test_frames=64, max_frames=640,
                                      display_step=10**9, seed=5),
                batch_per_device=16, engine="stream", stream_steps=4)
    base.update(kw)
    return cfg.BinarySimConfig(**base)


def _nb_cfg(**kw):
    base = dict(code="BDS.576.288.GF.64",
                decoder=cfg.NBDecoderConfig(method="qspa", max_iters=8),
                sweep=cfg.SweepConfig(snr_start=1.0, snr_step=0.5,
                                      snr_stop=1.0, least_error_frames=20,
                                      least_test_frames=64, max_frames=640,
                                      display_step=10**9, seed=5),
                batch_per_device=16, engine="stream", stream_steps=4)
    base.update(kw)
    return cfg.NBSimConfig(**base)


def _drive(engine, sig_table, pid, calls):
    """init, ``calls`` runs and the drain; the counters of each."""
    gen = torch.Generator().manual_seed(0)
    state = engine.init(gen, sig_table, pid)
    out = []
    for ci in range(1, calls + 1):
        state, c = engine.run(state, (0, ci), sig_table, pid)
        out.append(c)
    state, c = engine.drain(state)
    return out, c


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_binary_noiseless_exact_accounting(engine_kind, schedule):
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    scfg = _bin_cfg(add_noise=False, batch_per_device=4, stream_steps=5,
                    decoder=cfg.BinaryDecoderConfig(max_iters=6,
                                                    schedule=schedule))
    engine = sim.make_binary_stream_engine(code, scfg, CPU)
    assert engine.kernel == (engine_kind == "kernel")
    runs, drain = _drive(engine, torch.tensor([0.5]),
                         torch.zeros(4, dtype=torch.int64), 2)
    # per-iteration refill finishes B frames every iteration; per-call
    # refill B frames a call (every slot finishes at its first pass)
    per_run = 4 * (5 if engine_kind == "plain" else 1)
    for c in runs:
        assert c.tolist() == [[per_run, 0, 0, 0, 0, 0]]
    assert drain.tolist() == [[4, 0, 0, 0, 0, 0]]   # the frames in flight


def test_binary_noiseless_accounting_matches_jax():
    """The JAX package's jnp stream engine counts the same frames."""
    jc = JaxCode.from_registry("J4_L24_Z96")
    jcfg = jax_cfg.BinarySimConfig(
        code="J4_L24_Z96", decoder=jax_cfg.BinaryDecoderConfig(max_iters=6),
        batch_per_device=4, engine="stream", stream_steps=5, add_noise=False)
    init, run, drain, B = jax_sim.make_binary_stream_fn(
        jc, jcfg, jax_sim.get_mesh(jax.devices()[:1]))
    key = jax.random.PRNGKey(0)
    state = init(key, 0.5)
    state, c1 = run(state, jax.random.fold_in(key, 1), 0.5)
    _, cd = drain(state, jax.random.fold_in(key, 2), 0.5)
    engine = sim.make_binary_stream_engine(
        QCBinaryCode.from_registry("J4_L24_Z96"),
        _bin_cfg(add_noise=False, batch_per_device=4, stream_steps=5,
                 decoder=cfg.BinaryDecoderConfig(max_iters=6)), CPU)
    (ours,), our_drain = _drive(engine, torch.tensor([0.5]),
                                torch.zeros(4, dtype=torch.int64), 1)
    assert ours[0].tolist() == [int(x) for x in np.asarray(c1)]
    assert our_drain[0].tolist() == [int(x) for x in np.asarray(cd)]


def test_nb_noiseless_exact_accounting(engine_kind):
    code = NBCode.from_registry("LDPC_N96_K48_GF256_d1_exp")
    scfg = _nb_cfg(code=code.name, batch_per_device=3, stream_steps=5,
                   decoder=cfg.NBDecoderConfig(method="qspa", max_iters=6))
    engine = sim.make_nb_stream_engine(code, scfg, CPU)
    runs, drain = _drive(engine, torch.tensor([1e-4]),
                         torch.zeros(3, dtype=torch.int64), 2)
    per_run = 3 * (5 if engine_kind == "plain" else 1)
    for c in runs:
        assert c.tolist() == [[per_run, 0, 0, 0, 0, 0]]
    assert drain.tolist() == [[3, 0, 0, 0, 0, 0]]


def test_packed_stream_noiseless_accounting_by_point(engine_kind):
    """Two points, refills alternating between them: each point's frames
    are the refills it was given, and nothing is lost in the drain."""
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    scfg = _bin_cfg(add_noise=False, batch_per_device=4, stream_steps=3,
                    decoder=cfg.BinaryDecoderConfig(max_iters=6,
                                                    schedule="layered"))
    engine = sim.make_binary_stream_engine(code, scfg, CPU, n_points=2)
    pid = torch.tensor([0, 1, 0, 1])
    runs, drain = _drive(engine, torch.tensor([0.5, 0.4]), pid, 2)
    per_point = 2 * (3 if engine_kind == "plain" else 1)
    for c in runs:
        assert c.tolist() == [[per_point, 0, 0, 0, 0, 0]] * 2
    assert drain.tolist() == [[2, 0, 0, 0, 0, 0]] * 2


def test_binary_random_noiseless_no_errors_across_refills(engine_kind):
    """Random codewords without noise: every frame passes its syndrome
    check at its first decide and decodes to its own codeword, so no
    finished frame counts an error bit, before or after a refill (a refill
    that left a slot's old codeword beside its new channel values would
    count errors at every refill)."""
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    scfg = _bin_cfg(add_noise=False, batch_per_device=4, stream_steps=3,
                    tx="random", decoder=cfg.BinaryDecoderConfig(
                        max_iters=6, check="syndrome"))
    engine = sim.make_binary_stream_engine(code, scfg, CPU)
    state = engine.init(torch.Generator().manual_seed(0), torch.tensor([0.5]),
                        torch.zeros(4, dtype=torch.int64))
    assert state[-1].dtype == torch.bool and state[-1].any()
    runs, drain = _drive(engine, torch.tensor([0.5]),
                         torch.zeros(4, dtype=torch.int64), 3)
    per_run = 4 * (3 if engine_kind == "plain" else 1)
    for c in runs:
        assert c.tolist() == [[per_run, 0, 0, 0, 0, 0]]
    assert drain.tolist() == [[4, 0, 0, 0, 0, 0]]
    with pytest.raises(ValueError, match="needs check='syndrome'"):
        sim.make_binary_stream_engine(code, _bin_cfg(tx="random"), CPU)


def test_nb_random_stream_high_snr_no_errors(engine_kind):
    """BDS.576.288.GF.64 under random codewords at Eb/N0 11 dB: every
    frame decodes to its own symbols (a few after an iteration), so no
    finished frame counts an error symbol; the slots' codewords ride the
    state through the refills."""
    code = NBCode.from_registry("BDS.576.288.GF.64")
    scfg = _nb_cfg(batch_per_device=4, stream_steps=3, tx="random",
                   decoder=cfg.NBDecoderConfig(method="qspa", max_iters=6))
    sigma = sim.channel.sigma_from_snr(11.0, code.rate, "ebn0")
    engine = sim.make_nb_stream_engine(code, scfg, CPU)
    runs, drain = _drive(engine, torch.tensor([sigma]),
                         torch.zeros(4, dtype=torch.int64), 3)
    frames = 0
    for c in runs + [drain]:
        assert c[0, 1:5].tolist() == [0, 0, 0, 0]
        frames += int(c[0, 0])
    # every refill puts new frames in: at least 4 a call and the drain's
    assert frames >= 4 * 4


def test_random_stream_kill_and_resume(tmp_path, monkeypatch, engine_kind):
    """A binary stream sweep of random codewords, killed and resumed from
    its checkpoint (the slots' codewords included), gives the
    uninterrupted run's rows; a zero-codeword checkpoint of the same sweep
    is not resumed as a random one."""
    scfg = _two_points(_bin_cfg(tx="random", decoder=cfg.BinaryDecoderConfig(
        max_iters=10, check="syndrome")))
    full = sim.run_binary_sweep(scfg, device=CPU, quiet=True)
    assert len(full.rows) == 2 and full.rows[0]["error_units"] > 0
    ck = str(tmp_path / "ck.json")
    zero = dataclasses.replace(scfg, tx="zero",
                               decoder=cfg.BinaryDecoderConfig(
                                   max_iters=10, check="zero"))
    monkeypatch.setattr(sim, "_STREAM_TEST_INTERRUPT", 3)
    with pytest.raises(KeyboardInterrupt):
        sim.run_binary_sweep(zero, device=CPU, checkpoint=ck, quiet=True)
    with pytest.raises(KeyboardInterrupt):
        sim.run_binary_sweep(scfg, device=CPU, checkpoint=ck, quiet=True)
    monkeypatch.setattr(sim, "_STREAM_TEST_INTERRUPT", None)
    resumed = sim.run_binary_sweep(scfg, device=CPU, checkpoint=ck,
                                   quiet=True)
    assert _counters(resumed.rows) == _counters(full.rows)


def _compatible(a, b):
    return stats.rates_compatible(a["error_frames"], a["frames"],
                                  b["error_frames"], b["frames"])


def test_binary_engines_agree_statistically(engine_kind):
    batch = sim.run_binary_sweep(_bin_cfg(engine="batch"), device=CPU,
                                 quiet=True).rows[0]
    stream = sim.run_binary_sweep(_bin_cfg(), device=CPU, quiet=True).rows[0]
    packed = sim.run_binary_sweep_packed(_bin_cfg(engine="batch"), device=CPU,
                                         quiet=True).rows[0]
    pstream = sim.run_binary_stream_packed(_bin_cfg(), device=CPU,
                                           quiet=True).rows[0]
    for r in (stream, packed, pstream):
        assert r["frames"] >= 64 and r["error_frames"] >= 20
        assert _compatible(batch, r), (batch, r)
    # the stream counts each frame's own iterations, the batch engines the
    # batch's: the stream's average is lower
    assert stream["avg_iters"] < batch["avg_iters"]


def test_nb_engines_agree_statistically():
    """(The kernel engine's GF(q) statistics are checked on the card by
    chip_smoke.py; its accounting here, above.)"""
    batch = sim.run_nb_sweep(_nb_cfg(engine="batch"), device=CPU,
                             quiet=True).rows[0]
    stream = sim.run_nb_sweep(_nb_cfg(), device=CPU, quiet=True).rows[0]
    packed = sim.run_nb_sweep_packed(_nb_cfg(engine="batch"), device=CPU,
                                     quiet=True).rows[0]
    pstream = sim.run_nb_stream_packed(_nb_cfg(), device=CPU,
                                       quiet=True).rows[0]
    for r in (stream, packed, pstream):
        assert r["frames"] >= 64 and r["error_frames"] >= 20
        assert _compatible(batch, r), (batch, r)
    # GF(q) frames stop on their own in every engine: the same average
    assert abs(batch["avg_iters"] - stream["avg_iters"]) < 1.5


def _two_points(scfg):
    return dataclasses.replace(scfg, sweep=dataclasses.replace(
        scfg.sweep, snr_start=3.2, snr_stop=3.6, least_error_frames=10,
        least_test_frames=64, max_frames=192))


@pytest.mark.parametrize("runner", ["stream", "stream_packed"])
def test_kill_and_resume_give_the_same_rows(tmp_path, monkeypatch,
                                            engine_kind, runner):
    run = {"stream": sim.run_binary_sweep,
           "stream_packed": sim.run_binary_stream_packed}[runner]
    scfg = _two_points(_bin_cfg(decoder=cfg.BinaryDecoderConfig(
        max_iters=10, schedule="layered")))
    full = run(scfg, device=CPU, quiet=True)
    assert len(full.rows) == 2
    ck = str(tmp_path / "ck.json")
    monkeypatch.setattr(sim, "_STREAM_TEST_INTERRUPT", 3)
    with pytest.raises(KeyboardInterrupt):
        run(scfg, device=CPU, checkpoint=ck, quiet=True)
    monkeypatch.setattr(sim, "_STREAM_TEST_INTERRUPT", None)
    resumed = run(scfg, device=CPU, checkpoint=ck, quiet=True)
    assert _counters(resumed.rows) == _counters(full.rows)
    again = run(scfg, device=CPU, checkpoint=ck, quiet=True)
    assert _counters(again.rows) == _counters(full.rows)


def test_nb_stream_kill_and_resume(tmp_path, monkeypatch):
    scfg = _nb_cfg(code="LDPC_N96_K48_GF256_d1_exp",
                   sweep=cfg.SweepConfig(snr_start=2.0, snr_step=1.0,
                                         snr_stop=3.0, least_error_frames=5,
                                         least_test_frames=48, max_frames=96,
                                         display_step=10**9, seed=2))
    full = sim.run_nb_sweep(scfg, device=CPU, quiet=True)
    ck = str(tmp_path / "ck.json")
    monkeypatch.setattr(sim, "_STREAM_TEST_INTERRUPT", 4)
    with pytest.raises(KeyboardInterrupt):
        sim.run_nb_sweep(scfg, device=CPU, checkpoint=ck, quiet=True)
    monkeypatch.setattr(sim, "_STREAM_TEST_INTERRUPT", None)
    resumed = sim.run_nb_sweep(scfg, device=CPU, checkpoint=ck, quiet=True)
    assert _counters(resumed.rows) == _counters(full.rows)


class _Killed(Exception):
    pass


def test_packed_batch_kill_and_resume(tmp_path, monkeypatch):
    scfg = _two_points(_bin_cfg(engine="batch"))
    full = sim.run_binary_sweep_packed(scfg, device=CPU, quiet=True)
    real_save, saves = sim._Checkpoint.save, []

    def save_then_die(self, *args):
        real_save(self, *args)
        saves.append(1)
        if len(saves) == 3:
            raise _Killed

    ck = str(tmp_path / "ck.json")
    monkeypatch.setattr(sim._Checkpoint, "save", save_then_die)
    with pytest.raises(_Killed):
        sim.run_binary_sweep_packed(scfg, device=CPU, checkpoint=ck,
                                    quiet=True)
    monkeypatch.undo()
    resumed = sim.run_binary_sweep_packed(scfg, device=CPU, checkpoint=ck,
                                          quiet=True)
    assert _counters(resumed.rows) == _counters(full.rows)


def test_stream_dispatch_on_a_card(monkeypatch):
    """auto on a card (and cuda) takes the kernel engines: K7 for qspa,
    layered_qspa and glayered_qspa on the adjacency codes; a GF(q) pair
    that K7 does not run (the Tanner code) raises, naming the ROADMAP item,
    before anything is allocated; cuda on the CPU raises; torch and the CPU
    take the plain engines."""
    card = torch.device("cuda", 0)                 # nothing runs
    assert sim._stream_uses_kernel("auto", card)
    assert sim._stream_uses_kernel("cuda", card)
    assert not sim._stream_uses_kernel("torch", card)
    assert not sim._stream_uses_kernel("auto", CPU)
    with pytest.raises(ValueError, match="CUDA"):
        sim._stream_uses_kernel("cuda", CPU)
    with pytest.raises(ValueError, match="kernel"):
        sim._stream_uses_kernel("pallas", CPU)
    tanner = NBCode.from_registry("Tanner_74_9_Z128_GF16")
    bds = NBCode.from_registry("BDS.576.288.GF.64")
    for method in ("qspa", "layered_qspa", "glayered_qspa"):
        scfg = _nb_cfg(code=tanner.name, decoder=cfg.NBDecoderConfig(
            method=method))
        with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 13"):
            sim.make_nb_stream_engine(tanner, scfg, card)
    # the kernel engine's step on BDS, built on the CPU with the kernel
    # engine forced (a card's source would allocate on the card)
    monkeypatch.setattr(sim, "_stream_uses_kernel", lambda kernel, d: True)
    monkeypatch.setattr(sim, "_kernel_stream", lambda kstep, *a: kstep)
    for method, layered in [("qspa", False), ("layered_qspa", True),
                            ("glayered_qspa", "glayered")]:
        kstep = sim.make_nb_stream_engine(bds, _nb_cfg(
            decoder=cfg.NBDecoderConfig(method=method)), CPU)
        assert kstep.func is cuda_qspa_stream.stream_step
        assert kstep.keywords == {"code": bds, "max_iters": 20,
                                  "layered": layered}
    monkeypatch.undo()
    with pytest.raises(ValueError, match="per-frame check"):
        sim.make_binary_stream_engine(
            QCBinaryCode.from_registry("J4_L24_Z96"),
            _bin_cfg(decoder=cfg.BinaryDecoderConfig(check="none")), CPU)


@pytest.mark.parametrize("argv", [["--packed"], ["--engine", "stream"],
                                  ["--packed", "--engine", "stream"]])
def test_cli_runs_the_new_engines_on_cpu(tmp_path, argv):
    out = tmp_path / "bin"
    assert cli.main(["binary", "--device", "cpu", "--code", "J4_L24_Z96",
                     "--batch", "16", "--max-iters", "6", "--snr", "3:0.6:3.6",
                     "--snr-type", "ebn0", "--least-error-frames", "1",
                     "--least-test-frames", "16", "--max-frames", "32",
                     "--stream-steps", "3", "--schedule", "layered",
                     "--out-dir", str(out), "--quiet", *argv]) == 0
    rows = [json.loads(x) for x in
            (out / "results.jsonl").read_text().splitlines()]
    assert [r["snr"] for r in rows] == [3.0, 3.6]
    assert all(r["kind"] == "binary" and r["frames"] >= 16 for r in rows)
    text = (out / "results.txt").read_text()
    assert ("PACKED" in text) == ("--packed" in argv)
    assert ("STREAMING" in text) == ("stream" in argv)
    out = tmp_path / "nb"
    assert cli.main(["nb", "--device", "cpu", "--code",
                     "LDPC_N96_K48_GF256_d1_exp", "--method", "qspa",
                     "--batch", "8", "--max-iters", "6", "--snr", "2:1:3",
                     "--least-error-frames", "1", "--least-test-frames", "8",
                     "--max-frames", "16", "--stream-steps", "3",
                     "--out-dir", str(out), "--quiet", *argv]) == 0
    rows = [json.loads(x) for x in
            (out / "results.jsonl").read_text().splitlines()]
    assert [r["snr"] for r in rows] == [2.0, 3.0]
    assert all(r["kind"] == "nb" and r["frames"] >= 8 for r in rows)
