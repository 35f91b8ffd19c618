"""Where the binary decode's time goes, by differential timing: counterpart
of cuda_ldpc_tpu's tools/profile_phases.py.

    python -m cuda_ldpc_torch.tools.profile_phases [--code J15_L30_Z1280]
        [--batch 4096] [--snr 2.2] [--reps 10] [--trace DIR] [--device cuda]
    python -m cuda_ldpc_torch.tools.profile_phases --protocol
        [--code J15_L30_Z1280] [--batch 4096]

On a CUDA device the decoder is the flooding min-sum kernel K1
(ops/cuda_minsum.py), on the CPU its plain version (ops/minsum.py).  It
measures:

* the channel draw alone (all-zero codeword, BPSK, AWGN at Eb/N0 ``snr``);
* the decoder's cost per iteration, from 2 against 12 iterations with
  check 'none' and early stop off, and the intercept of that line at 0
  iterations: the fixed cost less one check-node phase, since the last
  iteration of a flooding decode skips its check-node phase (so the
  intercept may be negative);
* on a card, the bytes K1 moves an iteration, counted from the code's
  shapes: K1 keeps each frame's T and compressed R on chip, so an
  iteration reads only chan, 4 B L Z bytes, where the on-chip plan leaves
  chan in device memory (J15_L30_Z1280), and nothing where it keeps chan on
  chip; and their share of the card's 3.35 TB/s at the measured time an
  iteration;
* the price per iteration of check 'zero' and of 'syndrome', from 12
  iterations against 12 with 'none';
* the plain path's VN and CN phases at B=256 (``minsum._vn_update``
  alone, then a whole iteration: the VN phase and ``_cn_update``, which is
  ``_row_stack`` and ``_cn_minsum`` per block row and the rolls back).

Times are CUDA events around ``reps`` calls after a warm-up call (the host
clock on the CPU).  ``--trace DIR`` records one decode (12 iterations,
check 'zero') with torch.profiler into DIR/trace.json; a failed trace
raises.  Prints one JSON line; on a card it carries the card's name and
power limit.

``--protocol`` (a card only) measures the min-sum batch decoders' early
stop (csrc/onchip.cuh) instead: for flooding and layered at Es/N0 -1.6,
-1.5 and -1.4 dB (the batch engine's J15_L30_Z1280 sweep points), maxIT
50, check 'zero', the decode with early stop against the same kernels run
for the batch's count of iterations without it (every frame to the end
in one launch), CUDA events around ``reps`` calls each: their difference
is what the protocol itself costs; then one decode traced with
torch.profiler gives each launch of the on-chip kernel its device time:
the first (every frame to its own stop), the resume (the frames behind on
to the batch's maximum K) and the lockstep steps (those after the stop
return at once).  One JSON line per point.  Run it in a process of its
own: a process that has run many kernels between earlier traces records
none in later ones.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
from cuda_ldpc_torch.ops import channel, cuda_minsum, minsum, onchip
from cuda_ldpc_torch.utils.device import card_info, resolve_device
from cuda_ldpc_torch.utils.timing import profiler_activities, time_ms

PLAIN_BATCH = 256
HBM_BYTES_PER_S = 3.35e12       # the H100 SXM's published HBM3 rate


def trace(fn, device: torch.device, path: str) -> str:
    """Record ``fn()`` with torch.profiler into the chrome trace ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with torch.profiler.profile(
            activities=profiler_activities(device)) as prof:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    return path


def measure(code_name: str = "J15_L30_Z1280", batch: int = 4096,
            snr: float = 2.2, device: str | torch.device = "cuda",
            reps: int = 10, trace_dir: str | None = None) -> dict:
    """The phase split as one dict of milliseconds (module docstring)."""
    device = resolve_device(device)
    code = QCBinaryCode.from_registry(code_name)
    sigma = channel.sigma_from_snr(snr, code.rate, "ebn0")
    cw = torch.zeros((code.L, code.Z), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def draw(b=batch):
        return channel.bpsk_awgn_llr(gen, cw, sigma, b)

    row = {"tool": "profile_phases", "code": code.name, "batch": batch,
           "snr_ebn0": snr, "device": str(device), "reps": reps,
           "card": card_info() if device.type == "cuda" else None,
           "decoder": ("flooding min-sum kernel (K1)" if device.type == "cuda"
                       else "plain flooding min-sum"),
           "channel_ms": time_ms(draw, device, reps)}
    chan = draw()

    def decode(iters, check):
        return lambda: cuda_minsum.decode_flooding(chan, code, iters,
                                                   check=check,
                                                   early_stop=False)

    t2 = time_ms(decode(2, "none"), device, reps)
    t12 = time_ms(decode(12, "none"), device, reps)
    per_iter = (t12 - t2) / 10
    row["decode_2_iters_ms"], row["decode_12_iters_ms"] = t2, t12
    row["decode_per_iter_ms"] = per_iter
    row["decode_intercept_ms"] = t2 - 2 * per_iter
    if device.type == "cuda":
        keep_chan = onchip.cached_plan(code, False).keep_chan
        nbytes = 0 if keep_chan else 4 * batch * code.L * code.Z
        row["k1_bytes_per_iter"] = nbytes
        row["k1_bandwidth_share"] = (nbytes / (per_iter * 1e-3)
                                     / HBM_BYTES_PER_S)
    for check in ("zero", "syndrome"):
        tc = time_ms(decode(12, check), device, reps)
        row[f"check_{check}_per_iter_ms"] = (tc - t12) / 12

    # the plain path's phases are separate PyTorch calls: time the VN phase
    # alone and a whole iteration
    chp = draw(PLAIN_BATCH)
    R0 = torch.zeros((PLAIN_BATCH, code.num_edges, code.Z),
                     dtype=torch.float32, device=device)

    def full_iteration():
        _, _, Q = minsum._vn_update(code, chp, R0)
        return minsum._cn_update(code, Q, 1.0, 0.0)

    tv = time_ms(lambda: minsum._vn_update(code, chp, R0), device, reps)
    tf = time_ms(full_iteration, device, reps)
    row.update({"plain_batch": PLAIN_BATCH, "plain_vn_ms": tv,
                "plain_cn_ms": tf - tv})
    if trace_dir:
        row["trace"] = trace(decode(12, "zero"), device,
                             os.path.join(trace_dir, "trace.json"))
    return row


PROTOCOL_SNRS = (-1.6, -1.5, -1.4)
PROTOCOL_MAX_ITERS = 50


def protocol(code_name: str = "J15_L30_Z1280", batch: int = 4096,
             device: str | torch.device = "cuda", reps: int = 3):
    """Yield one dict per schedule and point: the early-stop decode's and
    the fixed decode's ms, and the device ms of each launch of the on-chip
    kernel in one early-stop decode (module docstring)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("--protocol times the CUDA kernels' launches: it "
                         "needs a card")
    code = QCBinaryCode.from_registry(code_name)
    cw = torch.zeros((code.L, code.Z), dtype=torch.float32, device=device)
    for schedule in ("flooding", "layered"):
        decode = getattr(cuda_minsum, f"decode_{schedule}")
        for snr in PROTOCOL_SNRS:
            gen = torch.Generator(device=device).manual_seed(0)
            chan = channel.bpsk_awgn_llr(
                gen, cw, channel.sigma_from_snr(snr, code.rate, "esn0"),
                batch)
            iters = int(decode(chan, code, PROTOCOL_MAX_ITERS,
                               check="zero").iters)
            early_ms = time_ms(lambda: decode(chan, code, PROTOCOL_MAX_ITERS,
                                              check="zero"), device, reps)
            fixed_ms = time_ms(lambda: decode(chan, code, iters, check="zero",
                                              early_stop=False), device, reps)
            with torch.profiler.profile(
                    activities=profiler_activities(device)) as prof:
                res = decode(chan, code, PROTOCOL_MAX_ITERS, check="zero")
                torch.cuda.synchronize(device)
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            launches = [e["dur"] / 1e3 for e in sorted(
                (e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "kernel"
                 and "onchip_batch_kernel" in e.get("name", "")),
                key=lambda e: e["ts"])]
            if len(launches) != PROTOCOL_MAX_ITERS + 1:
                raise RuntimeError(f"the trace holds {len(launches)} "
                                   "launches of the on-chip kernel, not "
                                   f"{PROTOCOL_MAX_ITERS + 1}")
            yield {"tool": "profile_phases --protocol", "code": code.name,
                   "schedule": schedule, "batch": batch, "esn0": snr,
                   "max_iters": PROTOCOL_MAX_ITERS, "card": card_info(),
                   "iters": int(res.iters), "frames_ok": int(res.ok.sum()),
                   "early_stop_ms": early_ms, "fixed_ms": fixed_ms,
                   "protocol_ms": early_ms - fixed_ms,
                   "first_ms": launches[0], "resume_ms": launches[1],
                   "steps_ms": sum(launches[2:]),
                   "steps_run": sum(d > 0.01 for d in launches[2:]),
                   "launches_ms": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cuda_ldpc_torch.tools.profile_phases",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--code", default="J15_L30_Z1280")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--snr", type=float, default=2.2)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--trace", default="", metavar="DIR")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--protocol", action="store_true",
                    help="split the min-sum early stop by launch (a card)")
    args = ap.parse_args(argv)
    if args.protocol:
        for row in protocol(args.code, args.batch, args.device, args.reps):
            print(json.dumps(row), flush=True)
        return 0
    print(json.dumps(measure(args.code, args.batch, args.snr, args.device,
                             args.reps, args.trace or None)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
