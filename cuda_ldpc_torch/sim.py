"""Monte-Carlo SNR sweeps, binary and GF(q) batch engines (counterpart of
cuda_ldpc_tpu/sim.py: the shared sweep loop at 51-293, the binary batch engine
at 314-441 and 765-821, the reference-LCG channel at 444-506 and 824-861, the
GF(q) batch engine at 1117-1267 and 2262-2305).

* per-SNR counters: frames, error frames, error bits, iteration sum,
  undetected-error (FER_False) and false-alarm (FER_Alarm) frames;
* stop rule: errors >= least_error_frames AND frames >= least_test_frames,
  or frames >= max_frames, evaluated per batch;
* output: the reference's console row schema, appended to results.txt, plus
  JSONL — the same strings and keys as the JAX package;
* checkpoint/resume: counters persisted after every batch.

Noise: the device channel draws each batch from a ``torch.Generator`` on the
device, seeded by a fixed function of (seed, snr index, batch index), so a
resumed sweep redraws exactly the noise it would have drawn.  The
'reference' channel reproduces the CUDA reference's LCG on the host
(utils/native.py, utils/lcg.py), the same noise the JAX package sees, so its
rows equal the JAX package's exactly.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from cuda_ldpc_torch import config as cfg
from cuda_ldpc_torch.models.nb_code import NBCode
from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
from cuda_ldpc_torch.ops import (channel, cuda_minsum, cuda_qspa, cuda_qspa_qc,
                                 demod, minsum, nb_decode)
from cuda_ldpc_torch.utils import lcg as pylcg
from cuda_ldpc_torch.utils import native, registry
from cuda_ldpc_torch.utils.constellations import constellation
from cuda_ldpc_torch.utils.device import resolve_device


@dataclasses.dataclass
class SnrStats:
    """Counters for one SNR point (struct Simulation, bldpc_实习/struct.cuh:6-33)."""
    snr: float
    frames: int = 0
    error_frames: int = 0
    error_units: int = 0          # bits (binary) or symbols (NB)
    iter_sum: int = 0
    false_frames: int = 0        # bit errors but check passed  (FER_False)
    alarm_frames: int = 0        # no bit errors but check failed (FER_Alarm)
    decode_s: float = 0.0
    info_bits: int = 0
    units_per_frame: int = 1   # bits (binary) or symbols (NB) counted per frame
    # Frames covered by decode_s/info_bits.  The FIRST collected batch of each
    # point (per process run) is excluded from timing — it absorbs kernel
    # builds and warmup — so throughput numbers are steady-state and
    # comparable across runs/resumes (frames/FER counters still include it).
    timed_frames: int = 0

    @classmethod
    def from_checkpoint(cls, d: dict) -> "SnrStats":
        st = cls(**d)
        # Checkpoints written before timed_frames existed cover ALL collected
        # frames with decode_s.
        if st.decode_s > 0 and st.timed_frames == 0:
            st.timed_frames = st.frames
        return st

    @property
    def fer(self) -> float:
        return self.error_frames / max(self.frames, 1)

    @property
    def ber(self) -> float:
        return (self.error_units / max(self.frames, 1)
                / max(self.units_per_frame, 1))

    def row(self, kind: str) -> str:
        avg_it = self.iter_sum / max(self.frames, 1)
        if kind == "binary":
            return (f" {self.snr:.1f} {self.frames:8d}  {self.error_frames:4d}"
                    f"  {self.fer:6.4e}  {self.ber:6.4e}  {avg_it:.2f}"
                    f"  {self.false_frames / max(self.frames, 1):6.4e}"
                    f"  {self.alarm_frames / max(self.frames, 1):6.4e}")
        sec = self.decode_s / max(self.timed_frames or self.frames, 1)
        return (f" {self.snr:.1f} {self.frames:8d}  {self.error_frames:4d}"
                f"  {self.fer:6.4e}  {self.ber:6.4e}  {avg_it:.2f}"
                f"  {sec:6.4e}sec")

    def to_dict(self, kind: str) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = kind
        d["fer"] = self.fer
        d["ber"] = self.ber
        d["avg_iters"] = self.iter_sum / max(self.frames, 1)
        d["info_mbps"] = (self.info_bits / self.decode_s / 1e6
                          if self.decode_s else 0.0)
        return d


@dataclasses.dataclass
class SweepResult:
    rows: list[dict]

    def fer_curve(self) -> dict[float, float]:
        return {r["snr"]: r["fer"] for r in self.rows}


class _Checkpoint:
    """Atomic JSON checkpoint of sweep progress keyed by a config hash."""

    def __init__(self, path: str | None, key: str):
        self.path = path
        self.key = key
        self.state = {"key": key, "done": {}, "current": None}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    old = json.load(f)
                if old.get("key") == key:
                    self.state = old
            except (json.JSONDecodeError, OSError):
                pass

    def done_rows(self) -> dict:
        return self.state["done"]

    def current(self, snr: float):
        cur = self.state.get("current")
        if cur and abs(cur["stats"]["snr"] - snr) < 1e-9:
            return cur
        return None

    def save(self, stats: SnrStats | None, batch_idx: int, units: int):
        if not self.path:
            return
        if stats is not None:
            self.state["current"] = {"stats": dataclasses.asdict(stats),
                                     "batch_idx": batch_idx, "units": units}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f)
        os.replace(tmp, self.path)

    def finish_point(self, stats: SnrStats, kind: str):
        self.state["done"][f"{stats.snr:g}"] = stats.to_dict(kind)
        self.state["current"] = None
        self.save(None, 0, 0)


def _write_logo(kind: str, lines: list[str], out_dir: str | None, quiet: bool):
    """Config banner + column header, like the reference's WriteLogo
    (bldpc_实习/Simulation.cu:176-240)."""
    header = {
        "binary": ("  SNR   frames  errF    FER         BER        avgIT"
                   "   FER_False   FER_Alarm"),
        "nb": ("  SNR   frames  errF    FER         BER        avgIT"
               "   sec/frame"),
    }[kind]
    text = "\n".join(["*" * 70, *lines, "*" * 70, header])
    if not quiet:
        print(text, flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "results.txt"), "a") as f:
            f.write(text + "\n")


def _emit(row: str, jsonl: dict, out_dir: str | None, quiet: bool):
    if not quiet:
        print(row, flush=True)
    if out_dir:
        with open(os.path.join(out_dir, "results.txt"), "a") as f:
            f.write(row + "\n")
        with open(os.path.join(out_dir, "results.jsonl"), "a") as f:
            f.write(json.dumps(jsonl) + "\n")


def _config_key(*parts) -> str:
    blob = json.dumps([dataclasses.asdict(p) if dataclasses.is_dataclass(p)
                       else p for p in parts], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _run_sweep(kind: str, sweep: cfg.SweepConfig, units_per_frame: int,
               info_bits_per_frame: int, batch: int,
               step: Callable, out_dir: str | None, checkpoint: str | None,
               key_salt: str, quiet: bool,
               pipeline: bool = True) -> SweepResult:
    """Shared sweep loop.  ``step(snr_idx, batch_idx, snr)`` LAUNCHES one
    batch (asynchronously on a CUDA device) and returns a zero-arg
    ``collect`` that waits and returns ``(n_frames, err_frames, err_units,
    iter_sum, false_f, alarm_f)``.  With ``pipeline=True`` the loop keeps ONE
    launched batch in flight, so the host enqueues batch k+1 while the device
    works on batch k.  The stop rule is then evaluated on collected stats,
    so each point may run one batch past the rule; those frames are still
    counted (the reference itself only checks between batches,
    Simulation.cu:111-146).  ``pipeline=False`` collects every batch
    synchronously, reproducing the reference's exact stop behaviour (used by
    the reference-channel parity mode)."""
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    ck = _Checkpoint(checkpoint, key_salt)
    rows: list[dict] = []
    for si, snr in enumerate(sweep.snr_points()):
        done = ck.done_rows().get(f"{snr:g}")
        if done is not None:
            rows.append(done)
            continue
        stats = SnrStats(snr=snr, units_per_frame=units_per_frame)
        batch_idx = 0
        cur = ck.current(snr)
        if cur:
            stats = SnrStats.from_checkpoint(cur["stats"])
            batch_idx = cur["batch_idx"]
        collected = batch_idx
        first_collect = collected   # absorbs builds + warmup; untimed
        next_display = (stats.frames // sweep.display_step + 1) * sweep.display_step
        t_last = time.perf_counter()

        def consume(collect):
            nonlocal collected, next_display, t_last
            nf, ef, eu, its, ff, af = collect()
            now = time.perf_counter()
            stats.frames += nf
            stats.error_frames += ef
            stats.error_units += eu
            stats.iter_sum += its
            stats.false_frames += ff
            stats.alarm_frames += af
            if collected != first_collect:     # steady-state batches only
                stats.decode_s += now - t_last   # marginal wall time
                stats.info_bits += nf * info_bits_per_frame
                stats.timed_frames += nf
            t_last = now
            collected += 1
            ck.save(stats, collected, units_per_frame)
            if stats.frames >= next_display:
                _emit(stats.row(kind), stats.to_dict(kind), out_dir, quiet)
                next_display += sweep.display_step

        pending = None
        while True:
            stopped = ((stats.error_frames >= sweep.least_error_frames
                        and stats.frames >= sweep.least_test_frames)
                       or stats.frames >= sweep.max_frames)
            nxt = None
            if not stopped:
                nxt = step(si, batch_idx, snr)
                batch_idx += 1
            if not pipeline and nxt is not None:
                consume(nxt)
                continue
            if pending is not None:
                consume(pending)
            pending = nxt
            if nxt is None:
                break
        _emit(stats.row(kind), stats.to_dict(kind), out_dir, quiet)
        ck.finish_point(stats, kind)
        rows.append(stats.to_dict(kind))
    return SweepResult(rows=rows)


# --------------------------------------------------------------------------
# binary simulator
# --------------------------------------------------------------------------

# What the port does not run yet, and the ROADMAP.md item that ports it.
NOT_PORTED = {
    "engine=stream": "Queue 1 item 9 (binary stream engines)",
    "packed": "Queue 1 item 8 (binary packed engine)",
    "tx=random": "Queue 1 item 7 (models/encoder.py)",
    "profile": "Queue 1 item 6 (bench and tracing)",
    "msg_dtype": "Queue 1 item 4 (bfloat16 message storage)",
    "nb engine=stream": "Queue 1 item 14 (GF(q) stream engines)",
    "nb packed": "Queue 1 item 14 (GF(q) packed engine)",
    "nb tx=random": "Queue 1 items 7 and 11 (NBEncoder)",
    "nb method": "Queue 1 item 12 and kernel K8 (EMS/TMM)",
}


RULE_NAMES = {"minsum": "min-sum", "bp": "sum-product (bp)"}


def not_ported(what: str, detail: str = "") -> NotImplementedError:
    return NotImplementedError(f"{detail or what} is not ported to "
                               f"cuda_ldpc_torch yet (ROADMAP.md "
                               f"{NOT_PORTED[what]})")


def check_ported(sim: cfg.BinarySimConfig):
    """Raise NotImplementedError, naming the ROADMAP.md item, for a
    configuration the port does not run yet."""
    d = sim.decoder
    if d.msg_dtype != "float32":
        raise not_ported("msg_dtype")
    if sim.engine == "stream":
        raise not_ported("engine=stream")
    if sim.engine != "batch":
        raise ValueError(f"unknown engine {sim.engine!r}")
    if sim.tx == "random":
        raise not_ported("tx=random")
    if sim.tx != "zero":
        raise ValueError(f"unknown tx {sim.tx!r}")


def _pick_binary_decode(dec_cfg: cfg.BinaryDecoderConfig,
                        device: torch.device) -> Callable:
    """Decoder dispatch on schedule x kernel; the rule goes to the decoder
    as its ``rule`` argument.  ``auto`` takes the CUDA kernel on a CUDA
    device and the plain PyTorch version on the CPU; ``cuda`` on the CPU
    raises."""
    want = dec_cfg.kernel
    if want == "cuda" or (want == "auto" and device.type == "cuda"):
        if device.type != "cuda":
            raise ValueError("kernel='cuda' needs a CUDA device, got "
                             f"{device}")
        module = cuda_minsum
    elif want in ("auto", "torch"):
        module = minsum
    else:
        raise ValueError(f"unknown kernel {want!r} (expected auto|torch|cuda)")
    if dec_cfg.schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {dec_cfg.schedule!r} "
                         "(expected flooding|layered)")
    return getattr(module, f"decode_{dec_cfg.schedule}")


def _counters(res: minsum.DecodeResult, msg_cols: int) -> torch.Tensor:
    """The five packed counters of a zero-codeword batch: [error bits, error
    frames, undetected-error frames, false-alarm frames, iterations]."""
    errbits = res.hard[:, :msg_cols].sum(dim=(1, 2), dtype=torch.int64)
    has_err = errbits > 0
    return torch.stack([errbits.sum(),
                        (has_err | ~res.ok).sum(),
                        (has_err & res.ok).sum(),        # FER_False
                        (~has_err & ~res.ok).sum(),      # FER_Alarm
                        res.iters.to(torch.int64)])


def make_binary_step(code: QCBinaryCode, sim: cfg.BinarySimConfig,
                     device: torch.device):
    """Batch step: all-zero codeword -> BPSK -> AWGN -> flooding or layered
    min-sum or bp -> five counters on the device.  Returns
    (fn(generator, sigma), batch)."""
    check_ported(sim)
    dec = sim.decoder
    B = sim.batch_per_device
    decode = _pick_binary_decode(dec, device)
    msg_cols = code.L - code.J if dec.message_only else code.L
    cw = torch.zeros((code.L, code.Z), dtype=torch.float32, device=device)

    def step(generator: torch.Generator, sigma: float) -> torch.Tensor:
        if sim.add_noise:
            chan = channel.bpsk_awgn_llr(generator, cw, sigma, B)
        else:
            chan = channel.bpsk(cw).expand(B, -1, -1).contiguous()
        if dec.rule == "bp":
            # min-sum is scale-invariant, so it takes the raw samples as the
            # reference does (LDPC_Decoder.cu:203); sum-product needs the
            # true LLRs 2y/sigma^2
            chan = chan.mul_(2.0 / (sigma * sigma))
        res = decode(chan, code, dec.max_iters, alpha=dec.alpha,
                     beta=dec.beta, check=dec.check, rule=dec.rule)
        return _counters(res, msg_cols)

    return step, B


def make_binary_ref_channel_step(code: QCBinaryCode,
                                 sim: cfg.BinarySimConfig,
                                 device: torch.device):
    """Decode-only step for host-generated channel batches [B, L, Z] — the
    'reference' channel mode (the CUDA reference's exact LCG/Box-Muller
    noise, bldpc_实习/LDPC_Encoder.cu:25-56)."""
    check_ported(sim)
    dec = sim.decoder
    if dec.rule != "minsum":
        raise ValueError("channel='reference' exists for bit-parity with the "
                         "reference's min-sum; rule='bp' is unsupported there")
    decode = _pick_binary_decode(dec, device)
    msg_cols = code.L - code.J if dec.message_only else code.L

    def step(chan: np.ndarray) -> torch.Tensor:
        res = decode(torch.from_numpy(chan).to(device), code, dec.max_iters,
                     alpha=dec.alpha, beta=dec.beta, check=dec.check)
        return _counters(res, msg_cols)

    return step, sim.batch_per_device


def _ref_channel_source(code: QCBinaryCode, B: int):
    """Per-SNR-point generator of reference-sequence channel batches: the
    native library when it loads, else the pure-Python LCG (both bit-exact)."""
    use_native = native.available()
    cw = np.zeros(code.n, dtype=np.uint8)

    class Source:
        def __init__(self):
            self.seeds = pylcg.DEFAULT_SEEDS

        def reset(self):
            self.seeds = pylcg.DEFAULT_SEEDS

        def next(self, sigma: float) -> np.ndarray:
            if use_native:
                out, self.seeds = native.awgn_binary(cw, sigma, B, self.seeds)
            else:
                gen = pylcg.ReferenceLCG(self.seeds)
                out = pylcg.awgn_binary(gen, cw, sigma, B)
                self.seeds = tuple(gen.seed)
            # [CW_Len, B] frame-interleaved -> [B, L, Z]
            return out.T.reshape(B, code.L, code.Z).astype(np.float32)

    return Source()


def batch_seed(seed: int, snr_idx: int, batch_idx: int) -> int:
    """The device generator's seed for one batch: a fixed function of
    (seed, snr index, batch index), so a resumed sweep redraws the same
    noise and neighbouring batches draw unrelated streams."""
    words = np.random.SeedSequence(
        [seed % 2**64, snr_idx, batch_idx]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


class _Fetch:
    """Brings one counter vector to the host.  On a CUDA device the copy
    goes to pinned memory behind an event, so waiting for batch k does not
    also wait for batch k+1, which is already enqueued behind it."""

    def __init__(self, out: torch.Tensor):
        if out.device.type == "cuda":
            self.host = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(out.device))
        else:
            self.host, self.event = out, None

    def wait(self) -> list[int]:
        if self.event is not None:
            self.event.synchronize()
        return self.host.tolist()


def _binary_collect(out: torch.Tensor, B: int):
    fetch = _Fetch(out)

    def collect():
        errbits, errf, falsef, alarmf, iters = fetch.wait()
        # batch-global iteration count, weighted per frame like the
        # reference (Simulation.cu:258: Total_Iteration += iteraTime)
        return (B, errf, errbits, iters * B, falsef, alarmf)

    return collect


def run_binary_sweep(sim: cfg.BinarySimConfig,
                     device: str | torch.device = "cuda",
                     out_dir: str | None = None,
                     checkpoint: str | None = None,
                     quiet: bool = False) -> SweepResult:
    """Binary QC-LDPC FER sweep on ``device`` (batch engine, flooding or
    layered min-sum or bp, all-zero codeword)."""
    device = resolve_device(device)
    code = QCBinaryCode.from_registry(sim.code)
    if sim.channel == "reference":
        return _run_binary_sweep_ref(code, sim, device, out_dir, checkpoint,
                                     quiet)
    if sim.channel not in ("device", "jax"):
        raise ValueError(f"unknown channel {sim.channel!r} "
                         "(expected 'device' or 'reference')")
    fn, B = make_binary_step(code, sim, device)
    sweep = sim.sweep
    d = sim.decoder
    _write_logo("binary", [
        f" code: {code!r}",
        f" decoder: {d.schedule} {RULE_NAMES[d.rule]}, maxIT={d.max_iters}, "
        f"alpha={d.alpha}, beta={d.beta}, check={d.check}, "
        f"kernel={d.kernel}, dtype={d.msg_dtype}",
        f" tx: {sim.tx}, noise: {sim.add_noise}, batch: {B} ({device})",
        f" sweep: {sweep.snr_type} {sweep.snr_start}:{sweep.snr_step}:"
        f"{sweep.snr_stop}, stop at >={sweep.least_error_frames} errors & "
        f">={sweep.least_test_frames} frames, seed={sweep.seed}",
    ], out_dir, quiet)
    msg_cols = code.L - code.J if d.message_only else code.L

    def step(si, bi, snr):
        sigma = channel.sigma_from_snr(snr, code.rate, sweep.snr_type)
        gen = torch.Generator(device=device)
        gen.manual_seed(batch_seed(sweep.seed, si, bi))
        return _binary_collect(fn(gen, sigma), B)

    # the device generator (Philox on CUDA, Mersenne Twister on the CPU)
    # decides the noise, so a checkpoint must not resume across device types
    key_salt = _config_key(sim, {"kind": "binary", "B": B,
                                 "backend": f"torch-{device.type}"})
    return _run_sweep("binary", sweep, msg_cols * code.Z, code.k, B, step,
                      out_dir, checkpoint, key_salt, quiet)


def _run_binary_sweep_ref(code, sim: cfg.BinarySimConfig, device, out_dir,
                          checkpoint, quiet) -> SweepResult:
    """Binary sweep with the reference's exact deterministic channel (seeds
    reset to (173,173,173) at every SNR point).  Batch size must match the
    reference's Num_Frames_OneTime for sequence-identical batches."""
    fn, B = make_binary_ref_channel_step(code, sim, device)
    sweep = sim.sweep
    src = _ref_channel_source(code, B)
    msg_cols = code.L - code.J if sim.decoder.message_only else code.L
    state = {"si": -1, "produced": 0}

    def step(si, bi, snr):
        if si != state["si"]:          # new SNR point: reset the LCG
            src.reset()
            state["si"] = si
            state["produced"] = 0
        sigma = channel.sigma_from_snr(snr, code.rate, sweep.snr_type)
        # checkpoint resume mid-point: fast-forward the sequential LCG past
        # the batches already counted in the restored stats
        while state["produced"] < bi:
            src.next(sigma)
            state["produced"] += 1
        chan = src.next(sigma)
        state["produced"] += 1
        return _binary_collect(fn(chan), B)

    # the same key as the JAX package: both draw the same noise, so either
    # may resume the other's checkpoint
    key_salt = _config_key(sim, {"kind": "binary_ref", "B": B})
    # pipeline=False: this mode exists to reproduce the reference run
    # bit-exactly, including its up-to-date-stats stop rule
    return _run_sweep("binary", sweep, msg_cols * code.Z, code.k, B, step,
                      out_dir, checkpoint, key_salt, quiet, pipeline=False)


# --------------------------------------------------------------------------
# non-binary simulator
# --------------------------------------------------------------------------

# (code, method) pairs with no CUDA kernel yet: the kernels run the qspa and
# layered_qspa schedules on the adjacency codes (K5) and qspa and
# glayered_qspa on the QC code (K6).
NO_KERNEL_ITEM = "Queue 1 item 13 (GF(q) kernels for the other (code, method) pairs)"


def check_nb_ported(sim: cfg.NBSimConfig):
    """Raise NotImplementedError, naming the ROADMAP.md item, for a GF(q)
    configuration the port does not run yet."""
    method = sim.decoder.method
    if method not in nb_decode.METHODS:
        raise ValueError(f"unknown NB decoder method {method!r} "
                         f"(expected one of {nb_decode.METHODS})")
    if method not in nb_decode.QSPA_METHODS:
        raise not_ported("nb method", f"method={method}")
    if sim.engine == "stream":
        raise not_ported("nb engine=stream", "nb --engine stream")
    if sim.engine != "batch":
        raise ValueError(f"unknown engine {sim.engine!r}")
    if sim.tx == "random":
        raise not_ported("nb tx=random", "nb --tx random")
    if sim.tx not in ("zero", "fixture"):
        raise ValueError(f"unknown tx {sim.tx!r}")


def _nb_decoder_fn(code: NBCode, dec: cfg.NBDecoderConfig,
                   device: torch.device) -> Callable:
    """GF(q) decoder dispatch.  ``auto`` on a CUDA device (and ``cuda``)
    takes K5 (csrc/qspa.cu) for qspa and layered_qspa on the codes it
    supports and K6 (csrc/qspa_qc.cu) for qspa and glayered_qspa on the QC
    code, and raises for a pair neither kernel runs, rather than run the
    plain version silently; ``auto`` on the CPU and ``torch`` anywhere take
    the plain version; ``cuda`` on the CPU raises.  Unlike the JAX package
    (sim.py:1143-1152), K5 also serves flooding on the tiny GF(256) code."""
    method, want = dec.method, dec.kernel
    if want not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown kernel {want!r} (expected auto|torch|cuda)")
    if want == "cuda" or (want == "auto" and device.type == "cuda"):
        if device.type != "cuda":
            raise ValueError("kernel='cuda' needs a CUDA device, got "
                             f"{device}")
        kernels = [(cuda_qspa, {"qspa": "decode_flooding",
                                "layered_qspa": "decode_layered"}),
                   (cuda_qspa_qc, {"qspa": "decode_flooding",
                                   "glayered_qspa": "decode_layered"})]
        for module, names in kernels:
            if method in names and module.supports(code):
                return functools.partial(getattr(module, names[method]),
                                         code=code, max_iters=dec.max_iters)
        raise ValueError(f"no CUDA kernel decodes {code.name} with "
                         f"method={method!r} yet (ROADMAP.md "
                         f"{NO_KERNEL_ITEM}); --kernel torch runs the plain "
                         "PyTorch version")
    return functools.partial(nb_decode.decode, code=code, method=method,
                             max_iters=dec.max_iters)


def _nb_tx(code: NBCode, sim: cfg.NBSimConfig):
    """(labels fed to the modulator, tx symbols) for the configured source."""
    if sim.tx == "fixture":
        tx_syms = registry.load_test_codeword(code.n_sym)
    else:
        tx_syms = np.zeros(code.n_sym, dtype=np.int64)
    if sim.n_qam == 2:
        return demod.sym_to_bit(tx_syms, code.q_bit), tx_syms
    if sim.n_qam != code.q:
        raise ValueError(
            f"QAM order {sim.n_qam} must equal GF order {code.q} "
            "(the reference maps one symbol per constellation point, "
            "myNBLDPC/src/LDPC_Encoder.cpp:19-36)")
    return tx_syms, tx_syms


def _make_nb_source(code: NBCode, sim: cfg.NBSimConfig, B: int,
                    device: torch.device):
    """Frame source: (generator, sigma) -> (L [B, N, q], tx [N]).  tx='zero'
    | 'fixture' transmit a constant codeword (the reference's only modes —
    it has no encoder, myNBLDPC/include/codeword_test.h:1)."""
    pts = constellation(sim.n_qam)
    tx_labels, tx_syms = _nb_tx(code, sim)
    tx_dev = torch.as_tensor(tx_syms, dtype=torch.int32, device=device)

    def src(generator: torch.Generator, sigma: float):
        L = demod.nb_channel_llr(generator, tx_labels, pts, sigma, batch=B,
                                 q=code.q, device=device)
        return L, tx_dev

    return src


def _nb_counters(res: nb_decode.NBDecodeResult,
                 tx: torch.Tensor) -> torch.Tensor:
    """The five packed counters of a batch: [error symbols, error frames,
    undetected-error frames, false-alarm frames, iterations summed over
    frames] (sim.py:1253-1265)."""
    errsyms = (res.hard != tx).sum(dim=1, dtype=torch.int64)
    has_err = errsyms > 0
    return torch.stack([errsyms.sum(), has_err.sum(),
                        (has_err & res.ok).sum(),        # FER_False
                        (~has_err & ~res.ok).sum(),      # FER_Alarm
                        res.iters.sum(dtype=torch.int64)])


def make_nb_step(code: NBCode, sim: cfg.NBSimConfig, device: torch.device):
    """Batch step: codeword -> BPSK or QAM -> complex AWGN -> symbol LLRs ->
    QSPA decode -> five counters on the device.  Returns
    (fn(generator, sigma), batch)."""
    check_nb_ported(sim)
    B = sim.batch_per_device
    src = _make_nb_source(code, sim, B, device)
    decoder = _nb_decoder_fn(code, sim.decoder, device)

    def step(generator: torch.Generator, sigma: float) -> torch.Tensor:
        L, tx = src(generator, sigma)
        return _nb_counters(decoder(L), tx)

    return step, B


def run_nb_sweep(sim: cfg.NBSimConfig, device: str | torch.device = "cuda",
                 out_dir: str | None = None, checkpoint: str | None = None,
                 quiet: bool = False) -> SweepResult:
    """GF(q) LDPC FER sweep on ``device`` (batch engine, FFT-QSPA family)."""
    device = resolve_device(device)
    code = NBCode.from_registry(sim.code)
    fn, B = make_nb_step(code, sim, device)
    sweep = sim.sweep
    d = sim.decoder
    _write_logo("nb", [
        f" code: {code!r}",
        f" decoder: {d.method}, Nm={d.nm}, Nc={d.nc}, maxIT={d.max_iters}, "
        f"kernel={d.kernel}",
        f" modulation: {'BPSK' if sim.n_qam == 2 else f'{sim.n_qam}-QAM'}, "
        f"tx: {sim.tx}, batch: {B} ({device})",
        f" sweep: {sweep.snr_type} {sweep.snr_start}:{sweep.snr_step}:"
        f"{sweep.snr_stop}, stop at >={sweep.least_error_frames} errors & "
        f">={sweep.least_test_frames} frames, seed={sweep.seed}",
    ], out_dir, quiet)
    bits_per_sym = float(np.log2(sim.n_qam))

    def step(si, bi, snr):
        # sigma includes the log2(n_QAM)*rate factor (myNBLDPC/src/main.cu:221-228)
        sigma = channel.sigma_from_snr(snr, code.rate, sweep.snr_type,
                                       bits_per_sym)
        gen = torch.Generator(device=device)
        gen.manual_seed(batch_seed(sweep.seed, si, bi))
        fetch = _Fetch(fn(gen, sigma))

        def collect():
            errsyms, errf, falsef, alarmf, iters = fetch.wait()
            return (B, errf, errsyms, iters, falsef, alarmf)

        return collect

    key_salt = _config_key(sim, {"kind": "nb", "B": B,
                                 "backend": f"torch-{device.type}"})
    return _run_sweep("nb", sweep, code.n_sym, code.k_sym * code.q_bit, B,
                      step, out_dir, checkpoint, key_salt, quiet)
