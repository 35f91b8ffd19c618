"""Monte-Carlo SNR sweeps, binary and GF(q), with three engines
(counterpart of cuda_ldpc_tpu/sim.py: the shared sweep loop at 51-293, the
binary batch engine at 314-441 and 765-821, the reference-LCG channel at
444-506 and 824-861, the binary stream engine at 509-762, the packed
engines at 864-1110, the GF(q) batch and stream engines at 1117-1474 and
2240-2305, the packed stream engines and their sweep loops at 1477-2237).

* batch: each batch decodes until its slowest frame stops (the reference's
  host loop), one SNR point at a time;
* packed: every batch is split over all unfinished SNR points, each frame
  with its own sigma and point id, counters segment-summed per point;
* stream (continuous batching): a pool of B slots; a frame that finishes
  is counted and its slot refilled, so throughput follows the mean
  iteration count.  On a CUDA device the stream step is a kernel (K4
  binary, K7 GF(q)) that runs ``stream_steps`` passes a call and the slots
  are refilled between calls; the plain version (the CPU, or
  ``--kernel torch``) refills after every iteration, as the JAX package's
  jnp engine does.  Each point ends with a drain that finishes every frame
  in flight, so every started frame is counted exactly once;
* packed stream: one slot pool for all unfinished points, refills taking
  the point ids the sweep assigns round-robin.

Per-SNR counters: frames, error frames, error bits, iteration sum,
undetected-error (FER_False) and false-alarm (FER_Alarm) frames.  Stop rule:
errors >= least_error_frames AND frames >= least_test_frames, or frames >=
max_frames, evaluated per collected batch or call.  Output: the reference's
console row schema in results.txt plus JSONL, the same strings and keys as
the JAX package.  Checkpoint/resume: counters after every batch; the stream
engines also save their slot state every ``stream_ckpt_s`` seconds.

Noise: every draw comes from a ``torch.Generator`` on the device seeded by a
fixed function of the seed and the draw's indices (``batch_seed``): (point,
batch) for the batch engine, (batch) for the packed one, (point, call) for
a kernel stream call's refill and (point, call, iteration) for the plain
stream's per-iteration refill (packed streams drop the point).  Under
tx='random' each draw takes the frames' message bits first and their noise
after, from the same generator, and the stream engines carry each slot's
codeword in their state.  A resumed sweep therefore redraws exactly the
codewords and noise it would have drawn.  The
'reference' channel reproduces the CUDA reference's LCG on the host
(utils/native.py, utils/lcg.py), the same noise the JAX package sees, so its
rows equal the JAX package's exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import time
from typing import Callable, ContextManager, NamedTuple

import numpy as np
import torch

from cuda_ldpc_torch import config as cfg
from cuda_ldpc_torch.models.encoder import BinaryEncoder, NBEncoder
from cuda_ldpc_torch.models.nb_code import NBCode
from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
from cuda_ldpc_torch.ops import (channel, cuda_minsum, cuda_minsum_stream,
                                 cuda_nbms, cuda_qspa, cuda_qspa_qc,
                                 cuda_qspa_stream, demod, minsum, nb_decode)
from cuda_ldpc_torch.utils import lcg as pylcg
from cuda_ldpc_torch.utils import native, registry
from cuda_ldpc_torch.utils.constellations import constellation
from cuda_ldpc_torch.utils.device import resolve_device
from cuda_ldpc_torch.utils.timing import profiler_activities


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

    def save(self, stats: SnrStats | None, batch_idx: int, units: int,
             extra: dict | None = None):
        if not self.path:
            return
        if stats is not None:
            self.state["current"] = {"stats": dataclasses.asdict(stats),
                                     "batch_idx": batch_idx, "units": units,
                                     **(extra or {})}
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


def _point_done(st: SnrStats, sweep: cfg.SweepConfig) -> bool:
    """The stop rule of one SNR point."""
    return ((st.error_frames >= sweep.least_error_frames
             and st.frames >= sweep.least_test_frames)
            or st.frames >= sweep.max_frames)


def _accumulate(stats: list[SnrStats], seg: list, secs: float,
                info_bits_per_frame: int, timed: bool):
    """Add per-point counter rows (frames, error frames, error units,
    undetected, false alarm, iterations) to ``stats``; the seconds are
    shared out by frames."""
    total = sum(int(row[0]) for row in seg)
    for st, row in zip(stats, seg):
        nf, ef, eu, ff, af, its = (int(x) for x in row)
        st.frames += nf
        st.error_frames += ef
        st.error_units += eu
        st.false_frames += ff
        st.alarm_frames += af
        st.iter_sum += its
        if timed and total:
            st.decode_s += secs * nf / total
            st.info_bits += nf * info_bits_per_frame
            st.timed_frames += nf


def _config_key(*parts) -> str:
    blob = json.dumps([dataclasses.asdict(p) if dataclasses.is_dataclass(p)
                       else p for p in parts], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _run_sweep(kind: str, sweep: cfg.SweepConfig, units_per_frame: int,
               info_bits_per_frame: int, batch: int,
               step: Callable, out_dir: str | None, checkpoint: str | None,
               key_salt: str, quiet: bool,
               pipeline: bool = True,
               profile: Callable[[str], ContextManager] | None = None
               ) -> SweepResult:
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
    the reference-channel parity mode).

    ``profile(label)``, when given, is a context manager that traces batch
    1 of each point (batch 0 absorbs the builds and the warm-up), launched
    and collected inside it; label is ``<kind>_snr<snr:g>``.  The traced
    batch's counts are consumed when the untraced loop would consume them,
    so the rows are those of an untraced run; its wall time includes the
    profiler's."""
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
            # steady-state batches only; the marginal wall time
            _accumulate([stats], [(nf, ef, eu, ff, af, its)], now - t_last,
                        info_bits_per_frame, collected != first_collect)
            t_last = now
            collected += 1
            ck.save(stats, collected, units_per_frame)
            if stats.frames >= next_display:
                _emit(stats.row(kind), stats.to_dict(kind), out_dir, quiet)
                next_display += sweep.display_step

        pending = None
        while True:
            stopped = _point_done(stats, sweep)
            nxt = None
            if not stopped and profile is not None and batch_idx == 1:
                if pending is not None:       # batch 0 stays out of the trace
                    consume(pending)
                with profile(f"{kind}_snr{snr:g}"):
                    counts = step(si, batch_idx, snr)()
                pending = lambda counts=counts: counts
                batch_idx += 1
                if not pipeline:
                    consume(pending)
                    pending = None
                continue
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


@contextlib.contextmanager
def _profiled(root: str, device: torch.device, label: str):
    """torch.profiler around the block (CPU activity, and CUDA activity on a
    card) inside a record_function span named ``label``; the chrome trace
    goes to ``root/label/trace.json``.  A failure raises."""
    with torch.profiler.profile(
            activities=profiler_activities(device)) as prof:
        with torch.profiler.record_function(label):
            yield
    os.makedirs(os.path.join(root, label), exist_ok=True)
    prof.export_chrome_trace(os.path.join(root, label, "trace.json"))


def check_profile(profile_dir: str | None, engine: str):
    """``--profile DIR`` traces one batch of the batch engine a point:
    refused (ValueError) for the packed and stream engines, which run no
    such batch."""
    if profile_dir is not None and engine != "batch":
        raise ValueError("--profile traces one batch of the batch engine a "
                         f"point; the {engine} engine has none")


def _profiler(profile_dir: str | None, engine: str, device: torch.device):
    """The sweep loop's ``profile`` for ``--profile DIR``: None without a
    directory (``check_profile`` refuses the other engines)."""
    check_profile(profile_dir, engine)
    if profile_dir is None:
        return None
    return functools.partial(_profiled, profile_dir, device)


# --------------------------------------------------------------------------
# binary simulator
# --------------------------------------------------------------------------

RULE_NAMES = {"minsum": "min-sum", "bp": "sum-product (bp)"}


def check_ported(sim: cfg.BinarySimConfig):
    """Raise ValueError for a configuration that makes no sense: an unknown
    msg_dtype, engine or tx; msg_dtype bfloat16 on the stream engine (the
    TPU stream kernel stores float32 while the JAX stream core computes in
    bf16, cuda_ldpc_tpu/sim.py:543 and :625, so there is no one function to
    port); tx='random' with the zero check, or with the 'reference'
    channel, whose noise the reference draws for the all-zero codeword (the
    JAX package's reference channel sends the all-zero word whatever tx
    says, cuda_ldpc_tpu/sim.py:444-476; the port refuses)."""
    d = sim.decoder
    store = minsum.storage(d.msg_dtype)        # ValueError: unknown
    if sim.engine not in ("batch", "stream"):
        raise ValueError(f"unknown engine {sim.engine!r} "
                         "(expected 'batch' or 'stream')")
    if store is not None and sim.engine == "stream":
        raise ValueError("msg_dtype='bfloat16' runs on the batch engine "
                         "(and --packed) only: the stream engine stores "
                         "float32 by design (the TPU stream kernel has no "
                         "bf16 form)")
    if sim.tx not in ("zero", "random"):
        raise ValueError(f"unknown tx {sim.tx!r}")
    if sim.tx == "random":
        if d.check == "zero":
            raise ValueError("tx='random' needs check='syndrome' (the "
                             "reference's zero-check only works for the "
                             "all-zero codeword)")
        if sim.channel == "reference":
            raise ValueError("channel='reference' replays the reference's "
                             "noise of the all-zero codeword; it sends no "
                             "random codewords (tx='random' needs channel="
                             "'device')")


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


def _bit_errors(hard: torch.Tensor, cw: torch.Tensor | None,
                msg_cols: int) -> torch.Tensor:
    """Error bits a frame [B] over the first ``msg_cols`` block columns:
    the decisions against the sent codeword cw [B, L, Z] (bool), or against
    the all-zero word where cw is None (cuda_ldpc_tpu/sim.py:427-432)."""
    wrong = hard[:, :msg_cols]
    if cw is not None:
        wrong = wrong != cw[:, :msg_cols]
    return wrong.sum(dim=(1, 2), dtype=torch.int64)


def _counters(res: minsum.DecodeResult, msg_cols: int,
              cw: torch.Tensor | None = None) -> torch.Tensor:
    """The five packed counters of a batch: [error bits, error frames,
    undetected-error frames, false-alarm frames, iterations]; ``cw`` as in
    ``_bit_errors``."""
    errbits = _bit_errors(res.hard, cw, msg_cols)
    has_err = errbits > 0
    return torch.stack([errbits.sum(),
                        (has_err | ~res.ok).sum(),
                        (has_err & res.ok).sum(),        # FER_False
                        (~has_err & ~res.ok).sum(),      # FER_Alarm
                        res.iters.to(torch.int64)])


def _binary_source(code: QCBinaryCode, sim: cfg.BinarySimConfig, B: int,
                   device: torch.device) -> Callable:
    """Frame source: (generator, sigma) -> (chan [B, L, Z], cw), the sent
    codeword through BPSK and AWGN.  tx='zero' sends the all-zero word (cw
    None); tx='random' a random systematic codeword a frame (cw [B, L, Z]
    bool, codeword index l*Z + z at [l, z]), its message bits drawn from the
    generator first and the noise after them, so the noise's shape and
    place in the draw stay those of tx='zero'.  ``sigma`` is a float or a
    [B] tensor (per-frame noise levels)."""
    zero = torch.zeros((code.L, code.Z), dtype=torch.float32, device=device)
    enc = BinaryEncoder.from_code(code) if sim.tx == "random" else None

    def fresh(generator: torch.Generator, sigma):
        cw = None
        if enc is not None:
            msg = torch.randint(0, 2, (B, enc.k_eff), generator=generator,
                                dtype=torch.int8, device=device)
            cw = enc.encode_torch(msg).reshape(B, code.L, code.Z)
            chan = (channel.bpsk_awgn_frames(generator, cw, sigma)
                    if sim.add_noise else channel.bpsk(cw))
            cw = cw.bool()
        elif sim.add_noise:
            chan = channel.bpsk_awgn_llr(generator, zero, sigma, B)
        else:
            chan = channel.bpsk(zero).expand(B, -1, -1).contiguous()
        if sim.decoder.rule == "bp":
            # min-sum is scale-invariant, so it takes the raw samples as the
            # reference does (LDPC_Decoder.cu:203); sum-product needs the
            # true LLRs 2y/sigma^2
            scale = 2.0 / (sigma * sigma)
            if isinstance(scale, torch.Tensor):
                scale = scale.to(torch.float32).reshape(-1, 1, 1)
            chan = chan.mul_(scale)
        return chan, cw

    return fresh


def make_binary_step(code: QCBinaryCode, sim: cfg.BinarySimConfig,
                     device: torch.device):
    """Batch step: all-zero or random codeword -> BPSK -> AWGN -> flooding
    or layered min-sum or bp -> five counters on the device.  Returns
    (fn(generator, sigma), batch)."""
    check_ported(sim)
    dec = sim.decoder
    B = sim.batch_per_device
    decode = _pick_binary_decode(dec, device)
    msg_cols = code.L - code.J if dec.message_only else code.L
    fresh = _binary_source(code, sim, B, device)

    def step(generator: torch.Generator, sigma: float) -> torch.Tensor:
        chan, cw = fresh(generator, sigma)
        res = decode(chan, code, dec.max_iters, alpha=dec.alpha,
                     beta=dec.beta, check=dec.check, rule=dec.rule,
                     msg_dtype=dec.msg_dtype)
        return _counters(res, msg_cols, cw)

    return step, B


def make_binary_ref_channel_step(code: QCBinaryCode,
                                 sim: cfg.BinarySimConfig,
                                 device: torch.device):
    """Decode-only step for host-generated channel batches [B, L, Z] — the
    'reference' channel mode (the CUDA reference's exact LCG/Box-Muller
    noise, bldpc_实习/LDPC_Encoder.cu:25-56), which sends the all-zero
    codeword only: tx='random' is refused (``check_ported``)."""
    check_ported(sim)
    dec = sim.decoder
    if dec.rule != "minsum":
        raise ValueError("channel='reference' exists for bit-parity with the "
                         "reference's min-sum; rule='bp' is unsupported there")
    decode = _pick_binary_decode(dec, device)
    msg_cols = code.L - code.J if dec.message_only else code.L

    def step(chan: np.ndarray) -> torch.Tensor:
        res = decode(torch.from_numpy(chan).to(device), code, dec.max_iters,
                     alpha=dec.alpha, beta=dec.beta, check=dec.check,
                     msg_dtype=dec.msg_dtype)
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


def batch_seed(seed: int, *indices: int) -> int:
    """The device generator's seed for one draw: a fixed function of the
    seed and the draw's indices, e.g. (snr index, batch index) for the batch
    engine (module docstring), so a resumed sweep redraws the same noise and
    neighbouring draws are unrelated streams."""
    words = np.random.SeedSequence(
        [seed % 2**64, *indices]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def _generator(device: torch.device, seed: int, *indices: int):
    gen = torch.Generator(device=device)
    gen.manual_seed(batch_seed(seed, *indices))
    return gen


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
                     quiet: bool = False,
                     profile_dir: str | None = None) -> SweepResult:
    """Binary QC-LDPC FER sweep on ``device``, one SNR point at a time (batch
    or stream engine, flooding or layered min-sum or bp, the all-zero or a
    random codeword a frame).  ``profile_dir``: a torch.profiler trace of
    batch 1 of each point, ``profile_dir/binary_snr<snr>/trace.json`` (batch
    engine only)."""
    device = resolve_device(device)
    code = QCBinaryCode.from_registry(sim.code)
    profile = _profiler(profile_dir, sim.engine, device)
    if sim.channel == "reference":
        return _run_binary_sweep_ref(code, sim, device, out_dir, checkpoint,
                                     quiet, profile)
    if sim.channel not in ("device", "jax"):
        raise ValueError(f"unknown channel {sim.channel!r} "
                         "(expected 'device' or 'reference')")
    if sim.engine == "stream":
        return _run_binary_stream(code, sim, device, out_dir, checkpoint,
                                  quiet)
    fn, B = make_binary_step(code, sim, device)
    sweep = sim.sweep
    d = sim.decoder
    _write_logo("binary", _binary_banner(code, sim, B, device, "batch engine"),
                out_dir, quiet)
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
                      out_dir, checkpoint, key_salt, quiet, profile=profile)


def _run_binary_sweep_ref(code, sim: cfg.BinarySimConfig, device, out_dir,
                          checkpoint, quiet, profile=None) -> SweepResult:
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
                      out_dir, checkpoint, key_salt, quiet, pipeline=False,
                      profile=profile)


def _binary_sigmas(code: QCBinaryCode, sweep: cfg.SweepConfig) -> np.ndarray:
    return np.array([channel.sigma_from_snr(s, code.rate, sweep.snr_type)
                     for s in sweep.snr_points()], dtype=np.float32)


def _binary_banner(code: QCBinaryCode, sim: cfg.BinarySimConfig, B: int,
                   device: torch.device, engine: str) -> list[str]:
    d, sweep = sim.decoder, sim.sweep
    return [
        f" code: {code!r}  [{engine}]",
        f" decoder: {d.schedule} {RULE_NAMES[d.rule]}, maxIT={d.max_iters}, "
        f"alpha={d.alpha}, beta={d.beta}, check={d.check}, "
        f"kernel={d.kernel}, dtype={d.msg_dtype}",
        f" tx: {sim.tx}, noise: {sim.add_noise}, batch: {B} ({device})",
        f" sweep: {sweep.snr_type} {sweep.snr_start}:{sweep.snr_step}:"
        f"{sweep.snr_stop}, stop at >={sweep.least_error_frames} errors & "
        f">={sweep.least_test_frames} frames, seed={sweep.seed}",
    ]


def make_binary_packed_step(code: QCBinaryCode, sim: cfg.BinarySimConfig,
                            n_points: int, device: torch.device):
    """Packed multi-SNR batch step: each frame carries its own sigma and
    SNR-point id; decodes with K1/K2 (or their plain versions) through
    ``_pick_binary_decode``; returns per-point counters [S, 6] (frames,
    error frames, error bits, undetected, false alarm, iterations), the
    batch-global iteration count per frame as in sim.py:927-932 of the JAX
    package.  Returns (fn(generator, sigma_vec [B], pid [B]), batch)."""
    check_ported(sim)
    dec = sim.decoder
    B = sim.batch_per_device
    decode = _pick_binary_decode(dec, device)
    msg_cols = code.L - code.J if dec.message_only else code.L
    fresh = _binary_source(code, sim, B, device)

    def step(generator, sigma_vec, pid):
        chan, cw = fresh(generator, sigma_vec)
        res = decode(chan, code, dec.max_iters, alpha=dec.alpha,
                     beta=dec.beta, check=dec.check, rule=dec.rule,
                     msg_dtype=dec.msg_dtype)
        errbits = _bit_errors(res.hard, cw, msg_cols)
        has_err = errbits > 0
        per = torch.stack([torch.ones_like(errbits), (has_err | ~res.ok).long(),
                           errbits, (has_err & res.ok).long(),
                           (~has_err & ~res.ok).long(),
                           res.iters.long().expand(B)], dim=1)
        return _segment_sum(per, pid, n_points)

    return step, B


def run_binary_sweep_packed(sim: cfg.BinarySimConfig,
                            device: str | torch.device = "cuda",
                            out_dir: str | None = None,
                            checkpoint: str | None = None,
                            quiet: bool = False,
                            profile_dir: str | None = None) -> SweepResult:
    """All SNR points of a binary sweep at once, in packed batches."""
    check_profile(profile_dir, "packed")
    device = resolve_device(device)
    code = QCBinaryCode.from_registry(sim.code)
    sweep = sim.sweep
    points = sweep.snr_points()
    fn, B = make_binary_packed_step(code, sim, len(points), device)
    msg_cols = code.L - code.J if sim.decoder.message_only else code.L
    banner = _binary_banner(code, sim, B, device,
                            f"PACKED multi-SNR sweep, {len(points)} points")
    return _run_packed("binary", sweep, points, _binary_sigmas(code, sweep),
                       fn, B, msg_cols * code.Z, code.k, out_dir, quiet,
                       banner, device, checkpoint,
                       _config_key(sim, {"kind": "binary_packed", "B": B,
                                         "backend": f"torch-{device.type}"}))


class StreamEngine(NamedTuple):
    """A continuous-batching engine (the JAX package's (init_fn, run_fn,
    drain_fn, B)).  The state is a list of tensors; every frame carries an
    SNR-point id, and the sequential sweeps use one point.

      init(generator, sig_table [S], pid [B]) -> state
      run(state, seeds, sig_table, refill_pid [B]) -> (state, counters)
      drain(state) -> (state, counters)

    ``seeds`` are the leading arguments of ``batch_seed`` for the call's
    refills.  counters [S, 6]: frames, error frames, error units,
    undetected, false alarm and iterations of the frames that finished in
    the call, summed per point id.  ``kernel`` tells the engine that runs
    the CUDA stream step (per-call refill) from the plain one
    (per-iteration refill).  Under random codewords the state's last
    tensor is each slot's codeword, which a refill replaces with its new
    frame's, beside the new channel values (cuda_ldpc_tpu/sim.py:566,
    595-600)."""
    init: Callable
    run: Callable
    drain: Callable
    B: int
    kernel: bool


def _segment_sum(per: torch.Tensor, pid: torch.Tensor,
                 n_points: int) -> torch.Tensor:
    """Per-frame counter rows [B, 6] summed by point id -> [S, 6] int64."""
    return torch.zeros((n_points, per.shape[1]), dtype=torch.int64,
                       device=per.device).index_add_(0, pid, per)


def _slot_counts(done, ok, errs, t) -> torch.Tensor:
    """Counter rows [B, 6] of the frames that finished (done [B] bool): 1,
    has an error, errors, undetected error, false alarm, iterations."""
    d = done.long()
    has_err = errs > 0
    return torch.stack([d, d * has_err, d * errs, d * (has_err & ok),
                        d * (~has_err & ~ok), d * t.long()], dim=1)


def _tx_leaf(tx: torch.Tensor | None) -> list:
    """The state's codeword leaf: one tensor under per-frame codewords,
    none under a constant one."""
    return [] if tx is None else [tx]


def _plain_stream(core, ok_of: Callable, errors: Callable, fresh: Callable,
                  B: int, n_points: int, max_iters: int, steps: int,
                  device: torch.device) -> StreamEngine:
    """The plain engine over a decoder core (minsum.build_core or
    nb_decode.build_core): every iteration decides, checks and counts the
    finished frames, runs the core's step for the others, and puts fresh
    frames into the finished slots at once (the JAX package's jnp engine,
    sim.py:577-619 and 1562-1607).  ``fresh(gen, sigma)`` gives (chan, tx),
    tx None for a constant codeword; ``errors(hard, tx)``."""

    def init(gen, sig_table, pid):
        chan, tx = fresh(gen, sig_table[pid])
        c0, c1 = core.init(chan)
        return [c0, c1, torch.zeros(B, dtype=torch.int32, device=device),
                torch.ones(B, dtype=torch.bool, device=device), pid.clone(),
                *_tx_leaf(tx)]

    def one_pass(state, counters, refill=None):
        c0, c1, t, alive, pid, *tx = state
        tx = tx[0] if tx else None
        hard, totals = core.decide((c0, c1))
        ok = ok_of(hard)
        done = alive & (ok | (t >= max_iters))
        counters.index_add_(0, pid, _slot_counts(done, ok, errors(hard, tx),
                                                 t))
        cont = alive & ~done
        c0, c1 = core.step((c0, c1), totals, cont)
        if refill is None:               # drain: finished slots stay empty
            return [c0, c1, torch.where(cont, t + 1, t), cont, pid,
                    *_tx_leaf(tx)]
        gen, sig_table, refill_pid = refill
        pid = torch.where(done, refill_pid, pid)
        chan, new_tx = fresh(gen, sig_table[pid])
        n0, n1 = core.init(chan)
        if tx is not None:
            tx = minsum._freeze(done, new_tx, tx)
        return [minsum._freeze(done, n0, c0), minsum._freeze(done, n1, c1),
                torch.where(done, 0, t + 1), alive, pid, *_tx_leaf(tx)]

    def run(state, seeds, sig_table, refill_pid):
        counters = torch.zeros((n_points, 6), dtype=torch.int64, device=device)
        for i in range(steps):
            state = one_pass(state, counters, (_generator(device, *seeds, i),
                                               sig_table, refill_pid))
        return state, counters

    def drain(state):
        # every running frame finishes within max_iters + 1 passes
        counters = torch.zeros((n_points, 6), dtype=torch.int64, device=device)
        for _ in range(max_iters + 1):
            if not bool(state[3].any()):
                break
            state = one_pass(state, counters)
        return state, counters

    return StreamEngine(init, run, drain, B, False)


def _kernel_stream(kstep: Callable, msg_shape: tuple, errors: Callable,
                   fresh: Callable, B: int, n_points: int, max_iters: int,
                   steps: int, device: torch.device) -> StreamEngine:
    """The kernel engine: one call of the stream step ``kstep`` (K4 or K7)
    runs ``steps`` passes; between calls the finished slots get fresh
    channel values and their counts reset (their messages leave the kernel
    zeroed).  The drain call runs max_iters + 1 passes, enough to finish
    every frame (the JAX package's fused engines, sim.py:702-734 and
    1888-1905).  ``fresh`` and ``errors`` as in ``_plain_stream``; a
    refilled slot's codeword is replaced together with its channel
    values."""

    def init(gen, sig_table, pid):
        flags = [torch.zeros(B, dtype=torch.int32, device=device)
                 for _ in range(3)]
        chan, tx = fresh(gen, sig_table[pid])
        return [chan, torch.zeros((B,) + msg_shape, dtype=torch.float32,
                                  device=device), *flags, pid.clone(),
                *_tx_leaf(tx)]

    def call(state, k):
        chan, msgs, t, done, okf, pid, *tx = state
        hard = kstep(chan, msgs, t, done, okf, k=k)[2]
        per = _slot_counts(done.bool(), okf.bool(),
                           errors(hard, tx[0] if tx else None), t)
        return _segment_sum(per, pid, n_points)

    def run(state, seeds, sig_table, refill_pid):
        counters = call(state, steps)
        chan, msgs, t, done, okf, pid, *tx = state
        fin = done.bool()
        pid = torch.where(fin, refill_pid, pid)
        new, new_tx = fresh(_generator(device, *seeds), sig_table[pid])
        chan = minsum._freeze(fin, new, chan)
        tx = [minsum._freeze(fin, new_tx, old) for old in tx]
        t.mul_((~fin).to(torch.int32))
        done.zero_()
        okf.zero_()
        return [chan, msgs, t, done, okf, pid, *tx], counters

    def drain(state):
        return state, call(state, max_iters + 1)

    return StreamEngine(init, run, drain, B, True)


def _stream_uses_kernel(kernel: str, device: torch.device) -> bool:
    """``auto`` on a CUDA device and ``cuda`` take the kernel engine,
    ``auto`` on the CPU and ``torch`` the plain one; ``cuda`` on the CPU
    raises."""
    if kernel not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown kernel {kernel!r} (expected auto|torch|cuda)")
    if kernel == "cuda" or (kernel == "auto" and device.type == "cuda"):
        if device.type != "cuda":
            raise ValueError(f"kernel='cuda' needs a CUDA device, got {device}")
        return True
    return False


def make_binary_stream_engine(code: QCBinaryCode, sim: cfg.BinarySimConfig,
                              device: torch.device,
                              n_points: int = 1) -> StreamEngine:
    """The binary continuous-batching engine: K4 (csrc/minsum_stream.cu)
    with per-call refill under ``auto`` on a card and ``cuda``; the plain
    per-iteration engine over minsum.build_core under ``torch`` and on the
    CPU.  ``n_points`` > 1 for the packed stream."""
    check_ported(sim)
    dec = sim.decoder
    if dec.check == "none":
        raise ValueError("engine='stream' needs a per-frame check "
                         "('zero' or 'syndrome')")
    use_kernel = _stream_uses_kernel(dec.kernel, device)
    B = sim.batch_per_device
    msg_cols = code.L - code.J if dec.message_only else code.L
    fresh = _binary_source(code, sim, B, device)

    def errors(hard, cw):
        return _bit_errors(hard, cw, msg_cols)

    args = (errors, fresh, B, n_points, dec.max_iters, sim.stream_steps,
            device)
    if use_kernel:
        kstep = functools.partial(
            cuda_minsum_stream.stream_step, code=code,
            max_iters=dec.max_iters, alpha=dec.alpha, beta=dec.beta,
            check=dec.check, rule=dec.rule,
            layered=dec.schedule == "layered")
        return _kernel_stream(kstep, (code.num_edges, code.Z), *args)
    core = minsum.build_core(code, rule=dec.rule, schedule=dec.schedule,
                             alpha=dec.alpha, beta=dec.beta)
    return _plain_stream(core, lambda hard: minsum._check(code, hard,
                                                          dec.check),
                         *args)


def _run_binary_stream(code: QCBinaryCode, sim: cfg.BinarySimConfig,
                       device: torch.device, out_dir, checkpoint,
                       quiet) -> SweepResult:
    engine = make_binary_stream_engine(code, sim, device)
    sweep = sim.sweep
    msg_cols = code.L - code.J if sim.decoder.message_only else code.L
    banner = _binary_banner(code, sim, engine.B, device,
                            _stream_label(sim.stream_steps, engine))
    return _run_stream("binary", sweep, _binary_sigmas(code, sweep), engine,
                       msg_cols * code.Z, code.k, banner, out_dir,
                       checkpoint, quiet, device,
                       _stream_key(sim, "binary_stream", engine, device))


def run_binary_stream_packed(sim: cfg.BinarySimConfig,
                             device: str | torch.device = "cuda",
                             out_dir: str | None = None,
                             checkpoint: str | None = None,
                             quiet: bool = False,
                             profile_dir: str | None = None) -> SweepResult:
    """All SNR points of a binary sweep at once on one continuous-batching
    slot pool."""
    check_profile(profile_dir, "packed")
    device = resolve_device(device)
    code = QCBinaryCode.from_registry(sim.code)
    sweep = sim.sweep
    points = sweep.snr_points()
    engine = make_binary_stream_engine(code, sim, device, len(points))
    msg_cols = code.L - code.J if sim.decoder.message_only else code.L
    banner = _binary_banner(
        code, sim, engine.B, device,
        f"PACKED {_stream_label(sim.stream_steps, engine)}, "
        f"{len(points)} points")
    return _run_stream_packed(
        "binary", sweep, points, _binary_sigmas(code, sweep), engine,
        msg_cols * code.Z, code.k, banner, out_dir, checkpoint, quiet, device,
        _stream_key(sim, "binary_stream_packed", engine, device))


def _stream_label(steps: int, engine: StreamEngine) -> str:
    if engine.kernel:
        return f"STREAMING engine, kernel, {steps} iters/call"
    return f"STREAMING engine, plain, {steps} iters/call, per-iteration refill"


def _stream_key(sim, kind: str, engine: StreamEngine,
                device: torch.device) -> str:
    # the device generator and the refill granularity decide the noise, so
    # a checkpoint resumes only on the same device type and engine
    return _config_key(sim, {"kind": kind, "B": engine.B,
                             "backend": f"torch-{device.type}",
                             "refill": "call" if engine.kernel
                             else "iteration"})


# --------------------------------------------------------------------------
# non-binary simulator
# --------------------------------------------------------------------------

# (code, method) pairs with no CUDA kernel yet, and the ROADMAP.md item that
# ports them: the QSPA kernels run every QSPA method on the adjacency codes
# (K5, and K7 on the stream engine) and every QSPA method on the QC code
# (K6: layered_qspa where its row groups are its block rows in order, as on
# Tanner_74_9_Z128_GF16), but no stream kernel runs the QC code; the
# max-domain kernel K8 runs ems (every Nm/Nc the plain version takes),
# ems_full, tmm, layered_tmm and glayered_tmm on the adjacency codes whose
# rows are full; no stream kernel runs a max-domain method.
NO_KERNEL_ITEM = ("Queue 1 item 13 (GF(q) QSPA kernels for the pairs "
                  "without one: the QC Tanner code on the stream engine)")
NO_MAXDOMAIN_KERNEL_ITEM = ("Queue 1 item 19 (max-domain kernels for the "
                            "codes K8 does not take: rows of unequal degree, "
                            "q < 32)")
NO_MAXDOMAIN_STREAM_ITEM = ("Queue 1 item 20 (a stateful K8 for the stream "
                            "engine)")
K5_METHODS = {"qspa": "decode_flooding", "layered_qspa": "decode_layered",
              "glayered_qspa": "decode_glayered"}
K6_METHODS = {"qspa": "decode_flooding", "glayered_qspa": "decode_layered",
              "layered_qspa": "decode_layered"}
K8_METHODS = {"ems": "decode_ems", "ems_full": "decode_ems_full",
              "tmm": "decode_tmm", "layered_tmm": "decode_layered_tmm",
              "glayered_tmm": "decode_glayered_tmm"}


def check_nb_ported(sim: cfg.NBSimConfig):
    """Raise NotImplementedError, naming the ROADMAP.md item, for a GF(q)
    configuration the port does not run yet."""
    method = sim.decoder.method
    if method not in nb_decode.METHODS:
        raise ValueError(f"unknown NB decoder method {method!r} "
                         f"(expected one of {nb_decode.METHODS})")
    if sim.engine not in ("batch", "stream"):
        raise ValueError(f"unknown engine {sim.engine!r} "
                         "(expected 'batch' or 'stream')")
    if sim.tx not in ("zero", "fixture", "random"):
        raise ValueError(f"unknown tx {sim.tx!r}")


def _nb_decoder_fn(code: NBCode, dec: cfg.NBDecoderConfig,
                   device: torch.device) -> Callable:
    """GF(q) decoder dispatch.  ``auto`` on a CUDA device (and ``cuda``)
    takes K5 (csrc/qspa.cu) for qspa, layered_qspa and glayered_qspa on the
    codes it supports, K6 (csrc/qspa_qc.cu) for qspa and glayered_qspa on
    the QC code, and for layered_qspa where that equals glayered_qspa
    (``cuda_qspa_qc.layered_is_block_rows``), and K8 (csrc/nbms.cu) for
    ems (with its Nm/Nc), ems_full (which has no Nm/Nc), tmm, layered_tmm
    and glayered_tmm on the codes it supports, and raises for a pair no
    kernel runs, rather than run the plain version silently (an EMS Nm/Nc
    the plain version refuses raises its error first);
    ``auto`` on the CPU and ``torch`` anywhere take the plain version;
    ``cuda`` on the CPU raises.  Unlike the JAX package (sim.py:1143-1187),
    whose ``auto`` keeps EMS and TMM on jnp, the kernels serve every pair
    they take."""
    method, want = dec.method, dec.kernel
    if want not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown kernel {want!r} (expected auto|torch|cuda)")
    if want == "cuda" or (want == "auto" and device.type == "cuda"):
        if device.type != "cuda":
            raise ValueError("kernel='cuda' needs a CUDA device, got "
                             f"{device}")
        k6 = (method in K6_METHODS and cuda_qspa_qc.supports(code) and (
            method != "layered_qspa"
            or cuda_qspa_qc.layered_is_block_rows(code)))
        for module, names, takes in [
                (cuda_qspa, K5_METHODS, method in K5_METHODS
                 and cuda_qspa.supports(code)),
                (cuda_qspa_qc, K6_METHODS, k6)]:
            if takes:
                return functools.partial(getattr(module, names[method]),
                                         code=code, max_iters=dec.max_iters)
        nmnc = {}
        if method == "ems":
            nb_decode.check_ems(dec.nm, dec.nc, code.q, code.max_dc)
            nmnc = {"nm": dec.nm, "nc": dec.nc}
        if method in K8_METHODS and cuda_nbms.supports(code, **nmnc):
            return functools.partial(getattr(cuda_nbms, K8_METHODS[method]),
                                     code=code, max_iters=dec.max_iters,
                                     **nmnc)
        item = (NO_KERNEL_ITEM if method in nb_decode.QSPA_METHODS
                else NO_MAXDOMAIN_KERNEL_ITEM)
        raise ValueError(f"no CUDA kernel decodes {code.name} with "
                         f"method={method!r}"
                         + (f" Nm={dec.nm} Nc={dec.nc}" if method == "ems"
                            else "")
                         + f" yet (ROADMAP.md {item}); --kernel torch runs "
                         "the plain PyTorch version")
    return functools.partial(nb_decode.decode, code=code, method=method,
                             max_iters=dec.max_iters, nm=dec.nm, nc=dec.nc)


def _check_qam(code: NBCode, sim: cfg.NBSimConfig):
    if sim.n_qam not in (2, code.q):
        raise ValueError(
            f"QAM order {sim.n_qam} must equal GF order {code.q} "
            "(the reference maps one symbol per constellation point, "
            "myNBLDPC/src/LDPC_Encoder.cpp:19-36)")


def _nb_tx(code: NBCode, sim: cfg.NBSimConfig):
    """(labels fed to the modulator, tx symbols) of a constant codeword."""
    _check_qam(code, sim)
    if sim.tx == "fixture":
        tx_syms = registry.load_test_codeword(code.n_sym)
    else:
        tx_syms = np.zeros(code.n_sym, dtype=np.int64)
    if sim.n_qam == 2:
        return demod.sym_to_bit(tx_syms, code.q_bit), tx_syms
    return tx_syms, tx_syms


def _make_nb_source(code: NBCode, sim: cfg.NBSimConfig, B: int,
                    device: torch.device):
    """Frame source: (generator, sigma) -> (L [B, N, q], tx [B, N] int32),
    with ``sigma`` a float or a [B] tensor (cuda_ldpc_tpu/sim.py:1206-1240).
    tx='zero' | 'fixture' transmit a constant codeword (the reference's
    only modes — it has no encoder, myNBLDPC/include/codeword_test.h:1),
    broadcast to the batch; tx='random' draws message bits from the
    generator, then the noise, and encodes on the device
    (NBEncoder.encode_torch).  ``src.tx`` is the constant codeword's
    [B, N], None under tx='random'."""
    pts = constellation(sim.n_qam)
    if sim.tx == "random":
        _check_qam(code, sim)
        enc = NBEncoder.from_code(code)
        nbits = enc.k_eff * code.q_bit

        def src(generator: torch.Generator, sigma):
            mbits = torch.randint(0, 2, (B, nbits), generator=generator,
                                  dtype=torch.int8, device=device)
            tx = enc.encode_torch(mbits)
            return (demod.nb_channel_llr_tx(generator, tx, pts, sigma,
                                            code.q), tx)

        src.tx = None
        return src
    tx_labels, tx_syms = _nb_tx(code, sim)
    tx_dev = torch.as_tensor(tx_syms, dtype=torch.int32,
                             device=device).expand(B, -1)

    def src(generator: torch.Generator, sigma):
        L = demod.nb_channel_llr(generator, tx_labels, pts, sigma, batch=B,
                                 q=code.q, device=device)
        return L, tx_dev

    src.tx = tx_dev
    return src


def _nb_counters(res: nb_decode.NBDecodeResult,
                 tx: torch.Tensor) -> torch.Tensor:
    """The five packed counters of a batch against the sent symbols tx
    ([B, N], or [N] for every frame): [error symbols, error frames,
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
    decode with the configured method -> five counters on the device.
    Returns (fn(generator, sigma), batch)."""
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
                 quiet: bool = False,
                 profile_dir: str | None = None) -> SweepResult:
    """GF(q) LDPC FER sweep on ``device``, one SNR point at a time (batch or
    stream engine, any method of nb_decode.METHODS).  ``profile_dir``: a
    torch.profiler trace of batch 1 of each point,
    ``profile_dir/nb_snr<snr>/trace.json`` (batch engine only)."""
    device = resolve_device(device)
    code = NBCode.from_registry(sim.code)
    profile = _profiler(profile_dir, sim.engine, device)
    if sim.engine == "stream":
        return _run_nb_stream(code, sim, device, out_dir, checkpoint, quiet)
    fn, B = make_nb_step(code, sim, device)
    sweep = sim.sweep
    _write_logo("nb", _nb_banner(code, sim, B, device, "batch engine"),
                out_dir, quiet)
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
                      step, out_dir, checkpoint, key_salt, quiet,
                      profile=profile)


def _nb_sigmas(code: NBCode, sim: cfg.NBSimConfig) -> np.ndarray:
    bits_per_sym = float(np.log2(sim.n_qam))
    return np.array([channel.sigma_from_snr(s, code.rate, sim.sweep.snr_type,
                                            bits_per_sym)
                     for s in sim.sweep.snr_points()], dtype=np.float32)


def _nb_banner(code: NBCode, sim: cfg.NBSimConfig, B: int,
               device: torch.device, engine: str) -> list[str]:
    d, sweep = sim.decoder, sim.sweep
    return [
        f" code: {code!r}  [{engine}]",
        f" decoder: {d.method}"
        + (f", Nm={d.nm}, Nc={d.nc}" if d.method == "ems" else "")
        + f", maxIT={d.max_iters}, kernel={d.kernel}",
        f" modulation: {'BPSK' if sim.n_qam == 2 else f'{sim.n_qam}-QAM'}, "
        f"tx: {sim.tx}, batch: {B} ({device})",
        f" sweep: {sweep.snr_type} {sweep.snr_start}:{sweep.snr_step}:"
        f"{sweep.snr_stop}, stop at >={sweep.least_error_frames} errors & "
        f">={sweep.least_test_frames} frames, seed={sweep.seed}",
    ]


def make_nb_packed_step(code: NBCode, sim: cfg.NBSimConfig, n_points: int,
                        device: torch.device):
    """Packed multi-SNR GF(q) batch step: per-frame sigma and point id,
    decoded with K5/K6/K8 (or the plain version) through ``_nb_decoder_fn``;
    per-point counters [S, 6].  Returns (fn(generator, sigma_vec, pid),
    batch)."""
    check_nb_ported(sim)
    B = sim.batch_per_device
    src = _make_nb_source(code, sim, B, device)
    decoder = _nb_decoder_fn(code, sim.decoder, device)

    def step(generator, sigma_vec, pid):
        L, tx = src(generator, sigma_vec)
        res = decoder(L)
        errsyms = (res.hard != tx).sum(dim=1, dtype=torch.int64)
        has_err = errsyms > 0
        per = torch.stack([torch.ones_like(errsyms), has_err.long(), errsyms,
                           (has_err & res.ok).long(),
                           (~has_err & ~res.ok).long(), res.iters.long()],
                          dim=1)
        return _segment_sum(per, pid, n_points)

    return step, B


def run_nb_sweep_packed(sim: cfg.NBSimConfig,
                        device: str | torch.device = "cuda",
                        out_dir: str | None = None,
                        checkpoint: str | None = None,
                        quiet: bool = False,
                        profile_dir: str | None = None) -> SweepResult:
    """All SNR points of a GF(q) sweep at once, in packed batches."""
    check_profile(profile_dir, "packed")
    device = resolve_device(device)
    code = NBCode.from_registry(sim.code)
    points = sim.sweep.snr_points()
    fn, B = make_nb_packed_step(code, sim, len(points), device)
    banner = _nb_banner(code, sim, B, device,
                        f"PACKED multi-SNR sweep, {len(points)} points")
    return _run_packed("nb", sim.sweep, points, _nb_sigmas(code, sim), fn, B,
                       code.n_sym, code.k_sym * code.q_bit, out_dir, quiet,
                       banner, device, checkpoint,
                       _config_key(sim, {"kind": "nb_packed", "B": B,
                                         "backend": f"torch-{device.type}"}))


def make_nb_stream_engine(code: NBCode, sim: cfg.NBSimConfig,
                          device: torch.device,
                          n_points: int = 1) -> StreamEngine:
    """The GF(q) continuous-batching engine: K7 (csrc/qspa_stream.cu) with
    per-call refill under ``auto`` on a card and ``cuda``, for qspa,
    layered_qspa and glayered_qspa on the codes K7 takes, raising for any
    other pair (no stream kernel runs the QC code or a max-domain method
    yet); the plain per-iteration engine over nb_decode.build_core (any
    method, any code) under ``torch`` and on the CPU."""
    check_nb_ported(sim)
    dec = sim.decoder
    use_kernel = _stream_uses_kernel(dec.kernel, device)
    layered = {"qspa": False, "layered_qspa": True,
               "glayered_qspa": "glayered"}.get(dec.method)
    if use_kernel and (layered is None or not cuda_qspa_stream.supports(code)):
        item = (NO_KERNEL_ITEM if dec.method in nb_decode.QSPA_METHODS
                else NO_MAXDOMAIN_STREAM_ITEM)
        raise ValueError(f"no CUDA stream kernel decodes {code.name} with "
                         f"method={dec.method!r} yet (ROADMAP.md {item}); "
                         "--kernel torch runs the plain PyTorch version")
    B = sim.batch_per_device
    src = _make_nb_source(code, sim, B, device)

    def fresh(gen, sigma):
        L, tx = src(gen, sigma)
        return L, tx if src.tx is None else None

    def errors(hard, tx):
        return (hard != (src.tx if tx is None else tx)).sum(
            dim=1, dtype=torch.int64)

    args = (errors, fresh, B, n_points, dec.max_iters, sim.stream_steps,
            device)
    if use_kernel:
        kstep = functools.partial(cuda_qspa_stream.stream_step, code=code,
                                  max_iters=dec.max_iters, layered=layered)
        E = int(code.cn_mask.sum())
        return _kernel_stream(kstep, (E, code.q), *args)
    core = nb_decode.build_core(code, dec.method, device, nm=dec.nm,
                                nc=dec.nc)
    return _plain_stream(core, lambda hard: nb_decode._syndrome_ok(core.g,
                                                                   hard),
                         *args)


def _run_nb_stream(code: NBCode, sim: cfg.NBSimConfig, device: torch.device,
                   out_dir, checkpoint, quiet) -> SweepResult:
    engine = make_nb_stream_engine(code, sim, device)
    banner = _nb_banner(code, sim, engine.B, device,
                        _stream_label(sim.stream_steps, engine))
    return _run_stream("nb", sim.sweep, _nb_sigmas(code, sim), engine,
                       code.n_sym, code.k_sym * code.q_bit, banner, out_dir,
                       checkpoint, quiet, device,
                       _stream_key(sim, "nb_stream", engine, device))


def run_nb_stream_packed(sim: cfg.NBSimConfig,
                         device: str | torch.device = "cuda",
                         out_dir: str | None = None,
                         checkpoint: str | None = None,
                         quiet: bool = False,
                         profile_dir: str | None = None) -> SweepResult:
    """All SNR points of a GF(q) sweep at once on one continuous-batching
    slot pool."""
    check_profile(profile_dir, "packed")
    device = resolve_device(device)
    code = NBCode.from_registry(sim.code)
    points = sim.sweep.snr_points()
    engine = make_nb_stream_engine(code, sim, device, len(points))
    banner = _nb_banner(code, sim, engine.B, device,
                        f"PACKED {_stream_label(sim.stream_steps, engine)}, "
                        f"{len(points)} points")
    return _run_stream_packed(
        "nb", sim.sweep, points, _nb_sigmas(code, sim), engine, code.n_sym,
        code.k_sym * code.q_bit, banner, out_dir, checkpoint, quiet, device,
        _stream_key(sim, "nb_stream_packed", engine, device))


# --------------------------------------------------------------------------
# the packed and stream sweep loops (binary and GF(q))
# --------------------------------------------------------------------------

def _round_robin(active: list[int], B: int, device) -> torch.Tensor:
    """Point ids of B frames split equally over ``active``, in order."""
    return torch.as_tensor(np.asarray(active, np.int64)[np.arange(B)
                                                        % len(active)],
                           device=device)


def _unfinished(stats: list[SnrStats], sweep: cfg.SweepConfig) -> list[int]:
    return [i for i, st in enumerate(stats) if not _point_done(st, sweep)]


def _run_packed(kind: str, sweep: cfg.SweepConfig, points: list[float],
                sigmas: np.ndarray, fn: Callable, B: int,
                units_per_frame: int, info_bits_per_frame: int, out_dir,
                quiet, banner: list[str], device: torch.device,
                checkpoint: str | None, key_salt: str) -> SweepResult:
    """Packed sweep loop (sim.py:940-1025 of the JAX package): every batch
    is split equally over the unfinished points; ``fn(generator, sigma_vec,
    pid)`` returns [S, 6] counters.  One batch stays in flight, so the
    active set lags one batch and a finishing point may get one more
    (counted) batch.  The checkpoint keeps the counters and the layout of
    the batch in flight, so a resumed sweep gives the uninterrupted rows."""
    sig_dev = torch.as_tensor(sigmas, device=device)
    stats = [SnrStats(snr=s, units_per_frame=units_per_frame) for s in points]
    ck = _Checkpoint(checkpoint, key_salt) if checkpoint else None
    bi0, inflight0 = 0, None
    if ck and ck.state.get("packed"):
        saved = ck.state["packed"]
        stats = [SnrStats.from_checkpoint(d) for d in saved["stats"]]
        bi0 = saved["batch_idx"]
        inflight0 = saved.get("inflight") or None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    _write_logo(kind, banner, out_dir, quiet)
    bi = consumed = bi0
    pending = None           # (fetch of the [S, 6] counters, active points)
    t_last = time.perf_counter()
    while True:
        active = inflight0 if inflight0 is not None else _unfinished(stats,
                                                                     sweep)
        inflight0 = None
        nxt = None
        if active:
            pid = _round_robin(active, B, device)
            nxt = (_Fetch(fn(_generator(device, sweep.seed, bi),
                             sig_dev[pid], pid)), active)
            bi += 1
        if pending is not None:
            seg = pending[0].wait()
            now = time.perf_counter()
            _accumulate(stats, seg, now - t_last, info_bits_per_frame,
                        timed=consumed != bi0)   # the first absorbs builds
            t_last = now
            consumed += 1
            if ck:
                ck.state["packed"] = {
                    "stats": [dataclasses.asdict(st) for st in stats],
                    "batch_idx": consumed,
                    "inflight": list(nxt[1]) if nxt is not None else None}
                ck.save(None, 0, 0)
        pending = nxt
        if nxt is None:
            break
    rows = []
    for st in stats:
        _emit(st.row(kind), st.to_dict(kind), out_dir, quiet)
        rows.append(st.to_dict(kind))
    return SweepResult(rows=rows)


def _save_state(path: str, state: list, pending: list):
    """The slot state and the in-flight call's counters, atomically."""
    arrs = {f"leaf{i}": x.cpu().numpy() for i, x in enumerate(state)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, pending=np.asarray(pending, np.int64),
                 nleaves=len(state), **arrs)
    os.replace(tmp, path)


def _load_state(path: str, device: torch.device):
    with np.load(path) as d:
        pending = _Fetch(torch.from_numpy(d["pending"]))
        state = [torch.from_numpy(d[f"leaf{i}"]).to(device)
                 for i in range(int(d["nleaves"]))]
    return pending, state


_STREAM_TEST_INTERRUPT: int | None = None   # tests: stop after N consumes


def _run_stream(kind: str, sweep: cfg.SweepConfig, sigmas: np.ndarray,
                engine: StreamEngine, units_per_frame: int,
                info_bits_per_frame: int, banner: list[str], out_dir,
                checkpoint, quiet, device: torch.device,
                key_salt: str) -> SweepResult:
    """Sequential stream sweep (sim.py:2112-2237 of the JAX package): per
    SNR point, one call in flight, the stop rule on collected counters,
    then a drain that finishes every frame in flight, so the tally is
    unbiased.  Every ``sweep.stream_ckpt_s`` seconds the slot state, the
    stats, the next call index and the in-flight call's counters go to
    ``<checkpoint>.state.npz`` and the checkpoint; a resumed sweep goes on
    with the same calls and noise and gives the uninterrupted run's rows."""
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    _write_logo(kind, banner, out_dir, quiet)
    ck = _Checkpoint(checkpoint, key_salt)
    spath = (checkpoint + ".state.npz") if checkpoint else None
    rows: list[dict] = []
    drain_first = True
    consumed_calls = 0
    zero_pid = torch.zeros(engine.B, dtype=torch.int64, device=device)
    for si, snr in enumerate(sweep.snr_points()):
        done_row = ck.done_rows().get(f"{snr:g}")
        if done_row is not None:
            rows.append(done_row)
            continue
        sig_table = torch.as_tensor(sigmas[si:si + 1], device=device)
        stats = [SnrStats(snr=snr, units_per_frame=units_per_frame)]
        ci, pending = 1, None
        cur = ck.current(snr)
        if cur and cur.get("stream_ci") and spath and os.path.exists(spath):
            stats = [SnrStats.from_checkpoint(cur["stats"])]
            ci = cur["stream_ci"]
            pending, state = _load_state(spath, device)
        else:
            state = engine.init(_generator(device, sweep.seed, si, 0),
                                sig_table, zero_pid)
        t_last = t_ckpt = time.perf_counter()
        first = True             # the first consume absorbs builds; untimed
        st = stats[0]
        next_display = (st.frames // sweep.display_step + 1) * sweep.display_step

        def consume(fetch, timed=True):
            nonlocal t_last, next_display
            now = time.perf_counter()
            _accumulate(stats, [fetch.wait()], now - t_last,
                        info_bits_per_frame, timed)
            t_last = now
            if st.frames >= next_display:
                _emit(st.row(kind), st.to_dict(kind), out_dir, quiet)
                next_display = ((st.frames // sweep.display_step + 1)
                                * sweep.display_step)

        def save(out, ci_now):
            if spath:
                _save_state(spath, state, out.wait())
                ck.save(st, 0, units_per_frame, {"stream_ci": ci_now})

        while True:
            # the stop rule before each launch: a sweep resumed from a save
            # made at the point's last call stops where the uninterrupted
            # run stopped
            if pending is not None and _point_done(st, sweep):
                break
            state, out = engine.run(state, (sweep.seed, si, ci), sig_table,
                                    zero_pid)
            out = _Fetch(out[0])
            ci += 1
            if pending is not None:
                consume(pending, timed=not first)
                first = False
                consumed_calls += 1
                if (_STREAM_TEST_INTERRUPT is not None
                        and consumed_calls >= _STREAM_TEST_INTERRUPT):
                    save(out, ci)
                    raise KeyboardInterrupt("stream test interrupt")
                now = time.perf_counter()
                if now - t_ckpt >= sweep.stream_ckpt_s:
                    save(out, ci)
                    t_ckpt = now
            pending = out
        consume(pending, timed=not first)
        state, out = engine.drain(state)
        # the first drain of the sweep may absorb a kernel build: untimed
        consume(_Fetch(out[0]), timed=not drain_first)
        drain_first = False
        _emit(st.row(kind), st.to_dict(kind), out_dir, quiet)
        ck.finish_point(st, kind)
        if spath and os.path.exists(spath):
            os.remove(spath)             # state consumed; drop the stale npz
        rows.append(st.to_dict(kind))
    return SweepResult(rows=rows)


def _run_stream_packed(kind: str, sweep: cfg.SweepConfig,
                       points: list[float], sigmas: np.ndarray,
                       engine: StreamEngine, units_per_frame: int,
                       info_bits_per_frame: int, banner: list[str], out_dir,
                       checkpoint, quiet, device: torch.device,
                       key_salt: str) -> SweepResult:
    """Packed stream sweep (sim.py:1911-2047 of the JAX package): one slot
    pool serves every unfinished point; each call's refills take point ids
    round-robin over the unfinished set; one call in flight; a final drain
    finishes every frame in flight.  The checkpoint keeps the counters, the
    slot state and the in-flight call's counters (<checkpoint>.pstate.npz):
    no started frame is lost, and a resumed sweep repeats the uninterrupted
    run's calls, noise and rows."""
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    _write_logo(kind, banner, out_dir, quiet)
    ck = _Checkpoint(checkpoint, key_salt)
    spath = (checkpoint + ".pstate.npz") if checkpoint else None
    done_rows = [ck.done_rows().get(f"{s:g}") for s in points]
    if all(r is not None for r in done_rows):
        return SweepResult(rows=done_rows)      # a finished sweep re-run
    sig_table = torch.as_tensor(sigmas, device=device)
    stats = [SnrStats(snr=s, units_per_frame=units_per_frame) for s in points]
    B = engine.B
    ci, pending = 1, None
    saved = ck.state.get("stream_packed")
    if saved and spath and os.path.exists(spath):
        stats = [SnrStats.from_checkpoint(d) for d in saved["stats"]]
        ci = saved["ci"]
        pending, state = _load_state(spath, device)
    else:
        state = engine.init(_generator(device, sweep.seed, 0), sig_table,
                            _round_robin(_unfinished(stats, sweep), B,
                                         device))
    t_last = t_ckpt = time.perf_counter()
    first = True
    consumed = 0

    def consume(fetch, timed=True):
        nonlocal t_last
        now = time.perf_counter()
        _accumulate(stats, fetch.wait(), now - t_last, info_bits_per_frame,
                    timed)
        t_last = now

    def save(out, ci_now):
        if spath:
            _save_state(spath, state, out.wait())
            ck.state["stream_packed"] = {
                "stats": [dataclasses.asdict(st) for st in stats],
                "ci": ci_now}
            ck.save(None, 0, 0)

    while True:
        active = _unfinished(stats, sweep)
        nxt = None
        if active:
            state, out = engine.run(state, (sweep.seed, ci), sig_table,
                                    _round_robin(active, B, device))
            nxt = _Fetch(out)
            ci += 1
        if pending is not None:
            consume(pending, timed=not first)
            first = False
            consumed += 1
            if (_STREAM_TEST_INTERRUPT is not None and nxt is not None
                    and consumed >= _STREAM_TEST_INTERRUPT):
                save(nxt, ci)
                raise KeyboardInterrupt("packed stream test interrupt")
            now = time.perf_counter()
            if nxt is not None and now - t_ckpt >= sweep.stream_ckpt_s:
                save(nxt, ci)
                t_ckpt = now
        pending = nxt
        if nxt is None:
            break
    state, out = engine.drain(state)
    consume(_Fetch(out), timed=False)      # the drain may absorb a build
    rows = []
    for st in stats:
        _emit(st.row(kind), st.to_dict(kind), out_dir, quiet)
        rows.append(st.to_dict(kind))
    if ck.path:
        ck.state.pop("stream_packed", None)
        for st in stats:
            ck.finish_point(st, kind)
    if spath and os.path.exists(spath):
        os.remove(spath)
    return SweepResult(rows=rows)
