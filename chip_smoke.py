"""Drive cuda_ldpc_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py          (from the root of the repository)

Phases, each printing JSON lines; any failure raises and exits non-zero:
  1. device   needs torch.cuda.is_available(); prints the card's name and
              power limit as nvidia-smi reports them
  2. build    builds every kernel in cuda_ldpc_torch/csrc/ with nvcc
  3. parity   each kernel vs its plain PyTorch version on the same CUDA
              tensors: J4_L24_Z96, J15_L30_Z1280 and PON_LDPC, checks zero /
              syndrome / none, early stop on and off, alpha 0.8 with beta
              0.1, 0 iterations, a ragged batch of 11, and the main path's
              shapes.  hard, ok and iters must be exactly equal.
  4. main     the main path through the CLI: a J15_L30_Z1280 FER sweep at
              B=4096, maxIT 50, around the waterfall, with the kernels'
              launch counts reset before and read after; then PON_LDPC,
              and J4_L24_Z96 at Eb/N0 3.6 dB whose FER must be statistically
              compatible with the reference's 33 errors in 2021 frames
  5. timing   J15_L30_Z1280, B=4096, 10 fixed iterations, one batch in
              flight: the kernel and the plain PyTorch path in turns
              (plain, kernel, kernel, plain)
The last lines are the card line, the kernels' JSON and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time


def _emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def _sweep(cli, out_dir: str, argv: list[str]) -> list[dict]:
    """One `python -m cuda_ldpc_torch binary ...` run, in process."""
    rc = cli.main(["binary", "--device", "cuda", "--out-dir", out_dir,
                   "--display-step", str(10**12), "--quiet", *argv])
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}")
    with open(os.path.join(out_dir, "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from cuda_ldpc_torch import QCBinaryCode, cli
    from cuda_ldpc_torch.ops import _build, channel, cuda_minsum, minsum
    from cuda_ldpc_torch.utils.device import card_info
    from cuda_ldpc_torch.utils.stats import rates_compatible

    # ---- 1. device
    dev = torch.device("cuda", 0)
    card = card_info()
    print(card, flush=True)
    _emit("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=card,
          torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log = (lib_path.parent / "build.log").read_text().splitlines()
    _emit("build", seconds=time.perf_counter() - t0,
          library=str(lib_path.relative_to(_build.BUILD_DIR.parent.parent)),
          ptxas=[ln.strip() for ln in log if "registers" in ln
                 or "spill" in ln or "Compiling entry" in ln])

    # ---- 3. kernel vs plain on the card
    def chan_for(code, snr_type, snr, batch, seed):
        sigma = channel.sigma_from_snr(snr, code.rate, snr_type)
        g = torch.Generator(device=dev).manual_seed(seed)
        cw = torch.zeros((code.L, code.Z), device=dev)
        return channel.bpsk_awgn_llr(g, cw, sigma, batch)

    cases = [
        # code, snr type, snr, batch, iters, check, early stop, alpha, beta
        ("J4_L24_Z96", "ebn0", 3.6, 4096, 50, "zero", True, 1.0, 0.0),
        ("J4_L24_Z96", "ebn0", 3.6, 11, 50, "syndrome", True, 0.8, 0.1),
        ("J4_L24_Z96", "ebn0", 3.0, 256, 20, "none", True, 1.0, 0.0),
        ("J4_L24_Z96", "ebn0", 3.6, 256, 20, "zero", False, 1.0, 0.0),
        ("J4_L24_Z96", "ebn0", 3.6, 64, 0, "zero", True, 1.0, 0.0),
        ("J15_L30_Z1280", "esn0", -1.5, 4096, 50, "zero", True, 1.0, 0.0),
        ("J15_L30_Z1280", "esn0", -1.3, 256, 50, "syndrome", True, 1.0, 0.0),
        ("J15_L30_Z1280", "esn0", -1.5, 256, 10, "none", False, 0.8, 0.1),
        ("PON_LDPC", "esn0", 2.45, 4096, 50, "zero", True, 1.0, 0.0),
        ("PON_LDPC", "esn0", 2.6, 512, 50, "syndrome", True, 1.0, 0.0),
        ("PON_LDPC", "esn0", 2.45, 512, 10, "zero", False, 0.8, 0.1),
    ]
    codes = {}
    max_err = 0.0
    for i, (name, st, snr, B, iters, check, early, alpha, beta) in \
            enumerate(cases):
        code = codes.setdefault(name, QCBinaryCode.from_registry(name))
        chan = chan_for(code, st, snr, B, seed=100 + i)
        kw = dict(alpha=alpha, beta=beta, check=check, early_stop=early)
        a = cuda_minsum.decode_flooding(chan, code, iters, **kw)
        b = minsum.decode_flooding(chan, code, iters, **kw)
        torch.cuda.synchronize()
        err = max((a.hard.int() - b.hard.int()).abs().max().item(),
                  (a.ok.int() - b.ok.int()).abs().max().item(),
                  abs(int(a.iters) - int(b.iters)))
        max_err = max(max_err, float(err))
        _emit("parity", code=name, snr=f"{st} {snr}", batch=B, iters=iters,
              check=check, early_stop=early, alpha=alpha, beta=beta,
              kernel_iters=int(a.iters), plain_iters=int(b.iters),
              frames_ok=int(a.ok.sum()), max_abs_err=err)
        if err != 0:
            raise AssertionError(f"kernel != plain on case {i}: {cases[i]}")
        del a, b, chan
    torch.cuda.empty_cache()

    # ---- 4. the main path, through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        cuda_minsum.LAUNCHES = 0
        t0 = time.perf_counter()
        rows = _sweep(cli, os.path.join(tmp, "j15"), [
            "--code", "J15_L30_Z1280", "--snr=-1.6:0.1:-1.4",
            "--snr-type", "esn0", "--max-iters", "50", "--batch", "4096",
            "--least-error-frames", "50", "--least-test-frames", "4096",
            "--max-frames", "12288"])
        sweep_s = time.perf_counter() - t0
        launches = cuda_minsum.LAUNCHES
        if launches <= 0:
            raise AssertionError("the J15_L30_Z1280 sweep never launched "
                                 "the CUDA kernel")
        keep = ("snr", "frames", "error_frames", "error_units", "fer", "ber",
                "avg_iters", "false_frames", "alarm_frames", "info_mbps")
        _emit("main_path", code="J15_L30_Z1280", seconds=sweep_s,
              launches=launches, rows=[{k: r[k] for k in keep} for r in rows])
        if len(rows) != 3 or not all(r["frames"] >= 4096 and
                                     0.0 <= r["fer"] <= 1.0 for r in rows):
            raise AssertionError(f"bad J15_L30_Z1280 rows: {rows}")
        if not rows[0]["fer"] >= rows[-1]["fer"]:
            raise AssertionError("FER does not fall across the waterfall")

        rows = _sweep(cli, os.path.join(tmp, "pon"), [
            "--code", "PON_LDPC", "--snr", "2.4:0.2:2.6", "--snr-type", "esn0",
            "--max-iters", "50", "--batch", "4096",
            "--least-error-frames", "50", "--least-test-frames", "4096",
            "--max-frames", "12288"])
        _emit("main_path", code="PON_LDPC",
              rows=[{k: r[k] for k in keep} for r in rows])
        if len(rows) != 2 or not all(0.0 <= r["fer"] <= 1.0 for r in rows):
            raise AssertionError(f"bad PON_LDPC rows: {rows}")

        rows = _sweep(cli, os.path.join(tmp, "j4"), [
            "--code", "J4_L24_Z96", "--snr", "3.6", "--snr-type", "ebn0",
            "--max-iters", "50", "--check", "zero", "--batch", "4096",
            "--least-error-frames", "200", "--least-test-frames", "8192",
            "--max-frames", "40960"])
        r = rows[-1]
        compatible = rates_compatible(r["error_frames"], r["frames"], 33, 2021)
        _emit("fer_anchor", code="J4_L24_Z96", ebn0=3.6,
              errors=r["error_frames"], frames=r["frames"], fer=r["fer"],
              reference="33/2021 = 1.633e-2", compatible=compatible)
        if not compatible:
            raise AssertionError("J4_L24_Z96 FER at Eb/N0 3.6 dB is not "
                                 "compatible with 33/2021")

    # ---- 5. timing: 10 fixed iterations, one batch in flight
    code = codes["J15_L30_Z1280"]
    B, iters, reps = 4096, 10, {"kernel": 20, "plain": 5}
    chans = [chan_for(code, "esn0", -1.5, B, seed=7 + i) for i in range(2)]
    decoders = {"kernel": cuda_minsum.decode_flooding,
                "plain": minsum.decode_flooding}

    def time_one(which: str) -> float:
        """Milliseconds per batch, host clock, device synchronised."""
        decode = decoders[which]

        def launch(i):
            res = decode(chans[i % 2], code, iters, check="zero",
                         early_stop=False)
            ev = torch.cuda.Event()
            ev.record()
            return res, ev

        launch(0)[1].synchronize()                       # warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prev = launch(0)
        for i in range(1, reps[which]):
            nxt = launch(i)
            prev[1].synchronize()         # wait for batch i-1 while i runs
            prev = nxt
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps[which]

    runs = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        runs[which].append(time_one(which))
    ms = {k: statistics.median(v) for k, v in runs.items()}
    mbps = {k: B * code.k / (v / 1e3) / 1e6 for k, v in ms.items()}
    _emit("timing", code=code.name, batch=B, iters=iters, card=card,
          ms_per_batch=runs, info_mbps=mbps)

    # ---- the kernels, the card, and the result
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "minsum_flooding", "route": "cuda",
        "source": "cuda_ldpc_torch/csrc/minsum_flooding.cu",
        "replaces": "cuda_ldpc_tpu/ops/pallas_minsum.py:251",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms["kernel"], "plain_ms": ms["plain"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
