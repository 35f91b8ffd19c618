"""Sweep throughput of the packed and stream engines on one CUDA device.

    python -m cuda_ldpc_torch.stream_bench            (needs a CUDA device)

Prints one JSON line per sweep, each with the card's name and power limit:

* the reference's committed binary workload as one packed sweep: PON_LDPC,
  Es/N0 0:0.2:13, flooding min-sum, maxIT 50, >= 50 errors and >= 10,000
  frames, 200,000 frames at most per point, B=4096; its total seconds,
  frames and info Mb/s, and the rows around the waterfall;
* the stream engine against ``stream_steps``: J15_L30_Z1280 flooding
  min-sum at Es/N0 -1.5 dB and BDS.576.288.GF.64 layered_qspa at Eb/N0
  1 dB, B=4096, with the kernel engine (K4 / K7, refilled per call) at 4,
  8, 16, 32 and 64 passes a call, the plain engine (refilled per
  iteration, ``--kernel torch``) at 16, and the batch engine, each sweep
  a fixed number of frames.

Throughput is the sweep rows' ``info_mbps``: steady-state wall time, the
first collected call of each point left out.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time


def _sweep(argv: list[str], out_dir: str) -> tuple[list[dict], float]:
    from cuda_ldpc_torch import cli
    t0 = time.perf_counter()
    rc = cli.main([argv[0], "--device", "cuda", "--out-dir", out_dir,
                   "--display-step", str(10**12), "--quiet", *argv[1:]])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}")
    with open(os.path.join(out_dir, "results.jsonl")) as f:
        return [json.loads(line) for line in f], seconds


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("stream_bench: needs a CUDA device", file=sys.stderr)
        return 1
    from cuda_ldpc_torch import QCBinaryCode
    from cuda_ldpc_torch.utils.device import card_info
    card = card_info()
    keep = ("snr", "frames", "error_frames", "fer", "avg_iters", "info_mbps")

    def emit(**kw):
        print(json.dumps({"card": card, **kw}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        rows, seconds = _sweep(
            ["binary", "--code", "PON_LDPC", "--packed", "--snr", "0:0.2:13",
             "--snr-type", "esn0", "--max-iters", "50", "--batch", "4096",
             "--least-error-frames", "50", "--least-test-frames", "10000",
             "--max-frames", "200000"], os.path.join(tmp, "pon"))
        frames = sum(r["frames"] for r in rows)
        k = QCBinaryCode.from_registry("PON_LDPC").k
        emit(sweep="PON_LDPC packed, Es/N0 0:0.2:13, 200k cap",
             points=len(rows), frames=frames, seconds=seconds,
             info_mbps=frames * k / seconds / 1e6,
             rows=[{c: r[c] for c in keep} for r in rows
                   if 2.0 <= r["snr"] <= 3.0])

        cases = [
            ("J15_L30_Z1280 flooding min-sum, Es/N0 -1.5",
             ["binary", "--code", "J15_L30_Z1280", "--snr=-1.5",
              "--snr-type", "esn0", "--max-iters", "50"]),
            ("BDS.576.288.GF.64 layered_qspa, Eb/N0 1",
             ["nb", "--code", "BDS.576.288.GF.64", "--method", "layered_qspa",
              "--snr", "1", "--max-iters", "20"]),
        ]
        frames = ["--batch", "4096", "--least-error-frames", "0",
                  "--least-test-frames", "40960", "--max-frames", "40960"]
        for label, argv in cases:
            runs = [("batch", [])]
            runs += [(f"stream kernel, {s} passes a call",
                      ["--engine", "stream", "--stream-steps", str(s)])
                     for s in (4, 8, 16, 32, 64)]
            runs += [("stream plain, per-iteration refill",
                      ["--engine", "stream", "--stream-steps", "16",
                       "--kernel", "torch", "--max-frames", "12288",
                       "--least-test-frames", "12288"])]
            for i, (engine, extra) in enumerate(runs):
                rows, seconds = _sweep(argv + frames + extra,
                                       os.path.join(tmp, f"{label[:3]}{i}"))
                emit(sweep=label, engine=engine, seconds=seconds,
                     **{c: rows[0][c] for c in keep})
    return 0


if __name__ == "__main__":
    sys.exit(main())
