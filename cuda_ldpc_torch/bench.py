"""The headline benchmark of the port: decoded info Mb/s of binary QC-LDPC
J15_L30_Z1280 (n=38400, k=19200), flooding min-sum, 10 fixed iterations,
one batch in flight (counterpart of the JAX package's bench.py).

    python -m cuda_ldpc_torch.bench                  (needs a CUDA device)

Environment switches, as bench.py's: BENCH_CODE (J15_L30_Z1280),
BENCH_BATCH (4096 on a card, the reference's own batch, define.cuh:60; 8
on the CPU), BENCH_ITERS (10), BENCH_SCHEDULE (flooding | layered),
BENCH_REPS (8), BENCH_KERNEL (auto: the CUDA kernel on a card and the
plain PyTorch version on the CPU | cuda | torch: the plain version),
BENCH_PROFILE=DIR (torch.profiler around the timed loop, a chrome trace
DIR/trace.json), and BENCH_DEVICE (cuda; cpu only when asked).
BENCH_DTYPE=bfloat16 is refused (ROADMAP.md Queue 1 item 4) and so is
BENCH_TILE, the TPU kernel's frame tile (item 17: not ported).

Two channel buffers (1 + 0.6 n, drawn on the device) alternate; the timed
loop launches decode k + 1 and then waits for decode k's ``ok``, whose copy
to pinned host memory was enqueued right behind it (bench.py:96-105).
Decodes run with check 'zero' and early stop off.

Prints ONE JSON line: the metric binary_minsum_info_mbps_<device type>
(binary_minsum_info_mbps_cuda on a card), its value in Mb/s, the card's
``nvidia-smi --query-gpu=name,power.limit`` line (null on the CPU), the
device, B, the iterations, the kernel and the schedule.  There is no
vs_baseline: bench.py's 1000 Mb/s baseline is a TPU target.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Mapping

import torch

from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
from cuda_ldpc_torch.ops import cuda_minsum, minsum
from cuda_ldpc_torch.sim import _Fetch
from cuda_ldpc_torch.utils.device import card_info, resolve_device
from cuda_ldpc_torch.utils.timing import profiler_activities


def _decoder(kernel: str, schedule: str, device: torch.device):
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"BENCH_SCHEDULE={schedule!r}: expected flooding or "
                         "layered")
    if kernel == "cuda" and device.type != "cuda":
        raise ValueError("BENCH_KERNEL=cuda needs a CUDA device")
    if kernel in ("auto", "cuda"):
        # the wrapper launches the kernel on a CUDA tensor and runs the plain
        # version on a CPU one
        return getattr(cuda_minsum, f"decode_{schedule}"), (
            "cuda" if device.type == "cuda" else "torch")
    if kernel == "torch":
        return getattr(minsum, f"decode_{schedule}"), "torch"
    raise ValueError(f"BENCH_KERNEL={kernel!r}: expected auto, cuda or torch")


def run(env: Mapping[str, str]) -> dict:
    """One bench line from the switches in ``env`` (module docstring)."""
    if env.get("BENCH_DTYPE", "float32") != "float32":
        raise NotImplementedError(
            f"BENCH_DTYPE={env['BENCH_DTYPE']} is not ported to "
            "cuda_ldpc_torch yet (ROADMAP.md Queue 1 item 4: bfloat16 "
            "message storage)")
    if "BENCH_TILE" in env:
        raise NotImplementedError("BENCH_TILE is the TPU kernel's frame tile "
                                  "and is not ported (ROADMAP.md item 17)")
    device = resolve_device(env.get("BENCH_DEVICE", "cuda"))
    code = QCBinaryCode.from_registry(env.get("BENCH_CODE", "J15_L30_Z1280"))
    B = int(env.get("BENCH_BATCH", "4096" if device.type == "cuda" else "8"))
    iters = int(env.get("BENCH_ITERS", "10"))
    reps = int(env.get("BENCH_REPS", "8"))
    schedule = env.get("BENCH_SCHEDULE", "flooding")
    decode, kernel = _decoder(env.get("BENCH_KERNEL", "auto"), schedule,
                              device)
    if reps < 1:
        raise ValueError(f"BENCH_REPS must be at least 1, got {reps}")

    def launch(chan):
        res = decode(chan, code, iters, check="zero", early_stop=False)
        return _Fetch(res.ok)

    bufs = [torch.randn((B, code.L, code.Z), dtype=torch.float32,
                        device=device,
                        generator=torch.Generator(device=device)
                        .manual_seed(i)).mul_(0.6).add_(1.0)
            for i in range(min(reps, 2))]
    chans = [bufs[i % len(bufs)] for i in range(reps)]
    launch(chans[0]).wait()                                # warm up

    profile_dir = env.get("BENCH_PROFILE")
    with (torch.profiler.profile(activities=profiler_activities(device))
          if profile_dir else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        prev = launch(chans[0])
        for chan in chans[1:]:
            nxt = launch(chan)
            prev.wait()                   # decode k while k + 1 runs
            prev = nxt
        prev.wait()
        dt = time.perf_counter() - t0
    line = {"metric": f"binary_minsum_info_mbps_{device.type}",
            "value": reps * B * code.k / dt / 1e6, "unit": "Mb/s",
            "card": card_info() if device.type == "cuda" else None,
            "device": str(device), "code": code.name, "batch": B,
            "iters": iters, "schedule": schedule, "kernel": kernel,
            "reps": reps, "seconds": dt}
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        line["trace"] = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(line["trace"])
    return line


def main() -> int:
    try:
        line = run(os.environ)
    except NotImplementedError as e:
        print(f"cuda_ldpc_torch.bench: {e}", file=sys.stderr)
        return 2
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
