"""Drive cuda_ldpc_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py          (from the root of the repository)

Phases, each printing JSON lines; any failure raises and exits non-zero:
  1. device   needs torch.cuda.is_available(); prints the card's name and
              power limit as nvidia-smi reports them
  2. build    builds every kernel in cuda_ldpc_torch/csrc/ with nvcc, one
              compiler per source, all at once
  3. parity   each kernel vs its plain PyTorch version on the same CUDA
              tensors.  Flooding and layered min-sum (K1, K2): J4_L24_Z96,
              J15_L30_Z1280 and PON_LDPC, checks zero / syndrome / none,
              early stop on and off, alpha 0.8 with beta 0.1, 0 iterations,
              a ragged batch of 11, and the main path's B=4096.  The bp rule
              in both schedules (K3) on true LLRs: J4_L24_Z96, J15_L30_Z1280
              and PON_LDPC at the main path's B=4096, and smaller batches.
              hard, ok and iters exactly equal; every mismatch is counted
              and printed.  GF(q) FFT-QSPA, flooding and layered: K5 on
              BDS.576.288.GF.64 at the main path's B=4096 (BPSK, Eb/N0 1 and
              2 dB, maxIT 20), a ragged batch of 11, early stop off, 0
              iterations and 64-QAM, and on LDPC_N576_K288_GF64_d1_exp,
              LDPC_N96_K48_GF256_d1_exp and LDPC_N576_K480_GF256_exp (BPSK
              and 256-QAM); K6 on Tanner_74_9_Z128_GF16 at B=256 in its
              waterfall (Eb/N0 3.3 dB) and above it (4.3 dB), and a ragged
              batch.  ok and iters exactly equal,
              hard exactly equal on frames whose check passed, every other
              difference counted
  4. main     the main path through the CLI, each sweep with every launch
              count set to 0 just before it and read just after: J15_L30_Z1280
              at B=4096, maxIT 50, around the waterfall, flooding and layered
              min-sum and bp; PON_LDPC flooding and layered min-sum; layered
              avg_iters no larger than flooding's at each point for bp, for
              PON_LDPC and for J15_L30_Z1280 min-sum with alpha 0.8
              (reported for J15_L30_Z1280 min-sum with alpha 1); J4_L24_Z96
              at Eb/N0 3.6 dB, min-sum and bp, whose FERs must be
              statistically compatible with the reference's 33/2021 and
              72/32768.  GF(q): `nb` qspa and layered_qspa on
              BDS.576.288.GF.64 at Eb/N0 1 dB, maxIT 20, B=4096, compatible
              with VALIDATION.md's 598/2304 and 872/4096, layered avg_iters no
              larger; a 64-QAM qspa sweep at 2 dB; Tanner_74_9_Z128_GF16 qspa
              and glayered_qspa across its waterfall, Eb/N0 3.2:0.2:3.6,
              B=256, FER not rising, glayered avg_iters no larger;
              layered_qspa on the Tanner code must be refused, naming the
              ROADMAP item
  5. timing   J15_L30_Z1280, B=4096, 10 fixed iterations, one batch in
              flight: each binary kernel and its plain PyTorch version in
              turns (plain, kernel, kernel, plain), then one kernel call
              under torch.profiler for its device time per CUDA kernel; the
              same for K5 on BDS.576.288.GF.64 at B=4096 and K6 on
              Tanner_74_9_Z128_GF16 at B=256, at most 10 passes, early stop
              off, at an Eb/N0 where most frames run every pass
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

# Published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
# sheet): HBM3 bandwidth and dense fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# The kernels of the main path: (name, source, TPU kernel it replaces).
KERNELS = [
    ("minsum_flooding", "cuda_ldpc_torch/csrc/minsum_flooding.cu",
     "cuda_ldpc_tpu/ops/pallas_minsum.py:251"),
    ("minsum_layered", "cuda_ldpc_torch/csrc/minsum_layered.cu",
     "cuda_ldpc_tpu/ops/pallas_minsum.py:299"),
    ("bp_flooding", "cuda_ldpc_torch/csrc/minsum_flooding.cu",
     "cuda_ldpc_tpu/ops/pallas_minsum.py:134"),
    ("bp_layered", "cuda_ldpc_torch/csrc/minsum_layered.cu",
     "cuda_ldpc_tpu/ops/pallas_minsum.py:134"),
    ("qspa_flooding", "cuda_ldpc_torch/csrc/qspa.cu",
     "cuda_ldpc_tpu/ops/pallas_qspa.py:302"),
    ("qspa_layered", "cuda_ldpc_torch/csrc/qspa.cu",
     "cuda_ldpc_tpu/ops/pallas_qspa.py:302"),
    ("qspa_qc_flooding", "cuda_ldpc_torch/csrc/qspa_qc.cu",
     "cuda_ldpc_tpu/ops/pallas_qspa_qc.py:326"),
    ("qspa_qc_layered", "cuda_ldpc_torch/csrc/qspa_qc.cu",
     "cuda_ldpc_tpu/ops/pallas_qspa_qc.py:326"),
]
BINARY = KERNELS[:4]


def _emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def _sweep(cli, out_dir: str, argv: list[str]) -> list[dict]:
    """One `python -m cuda_ldpc_torch binary|nb ...` run, in process; argv
    starts with the subcommand."""
    rc = cli.main([argv[0], "--device", "cuda", "--out-dir", out_dir,
                   "--display-step", str(10**12), "--quiet", *argv[1:]])
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}")
    with open(os.path.join(out_dir, "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def bound_ms(code, batch: int, iters: int, schedule: str, rule: str,
             check: str) -> tuple[float, str]:
    """The least time the card could take for one decode call of
    ``iters`` iterations without early stop: the larger of the bytes the
    function must move (chan read once, hard and ok written once) over the
    HBM rate, and its fp32 operations over the fp32 peak.  Operations are
    counted from the kernels' code, each add, subtract, compare, min/max,
    select, multiply, negate, logf or tanhf as one: per edge and iteration,
    min-sum's CN 6 (q, sign, |q|, two compares, the sign applied) and bp's
    17 (q, sign, |q|, clip 2, x/2, tanh, log, negate, sum; rest, clip,
    x/2, tanh, log, negate, sign); beta 2 and alpha 1 more; flooding's VN
    one add per edge and iteration and its CN skipped on the last
    iteration; layered's total update 2 per edge.  The zero check costs
    one compare per message bit, the syndrome check one XOR per edge."""
    lanes = batch * code.num_edges * code.Z
    cn = {"minsum": 6, "bp": 17}[rule]
    if schedule == "flooding":
        ops = lanes * (iters + cn * (iters - 1))
    else:
        ops = lanes * (cn + 2) * iters
    ops += iters * batch * {"zero": code.k, "syndrome": code.num_edges *
                            code.Z, "none": 0}[check]
    nbytes = batch * code.n * (4 + 1) + batch + 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def qspa_bound_ms(N: int, E: int, q: int, batch: int, iters, max_iters: int,
                  layered: bool) -> tuple[float, str]:
    """The least time the card could take for one GF(q) FFT-QSPA decode
    call that gave per-frame iteration counts ``iters``: the larger of the
    bytes it must move (chan [B, N, q] f32 read once; hard [B, N] i32, ok
    [B] and iters [B] i32 written once) over the HBM rate, and its fp32
    operations over the fp32 peak.  The work depends on the data: a frame
    that stops at pass t ran t + 1 passes and t check-node updates, one that
    never stops max_iters passes and max_iters - 1 updates.  Operations are
    counted from the kernels' code, each add, subtract, compare, max,
    multiply, divide, expf or logf as one, per real edge and symbol and
    check-node update: 1 (v2c) + 5 (softmax: max, subtract, exp, sum,
    divide) + log2 q (transform) + 3 (forward, backward and exclusive
    products) + log2 q (inverse) + 4 (divide by q, floor, log, minus the
    value at 0), and 2 more for layered's total update; per pass, 1 compare
    per VN and symbol for the decision and, for flooding, 1 add per edge
    and symbol plus 1 per VN and symbol for the totals."""
    import math
    iters = [int(i) for i in iters]
    updates = sum(min(i, max_iters - 1) for i in iters)
    passes = sum(min(i + 1, max_iters) for i in iters)
    lq = int(math.log2(q))
    ops = updates * E * q * (13 + 2 * lq + (2 if layered else 0))
    ops += passes * N * q * (1 if layered else 2)
    if not layered:
        ops += passes * E * q
    nbytes = batch * N * q * 4 + batch * N * 4 + batch * 5
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def time_turns(launch, reps: dict) -> dict:
    """Milliseconds per batch of ``launch(which, i)`` for which in
    'plain' and 'kernel', in turns plain, kernel, kernel, plain: host clock,
    one batch in flight, device synchronised."""
    import torch

    def time_one(which: str) -> float:
        def go(i):
            res = launch(which, i)
            ev = torch.cuda.Event()
            ev.record()
            return res, ev

        go(0)[1].synchronize()                           # warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prev = go(0)
        for i in range(1, reps[which]):
            nxt = go(i)
            prev[1].synchronize()         # wait for batch i-1 while i runs
            prev = nxt
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps[which]

    runs = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        runs[which].append(time_one(which))
    return runs


def profile_ms(call) -> dict:
    """Device time per CUDA kernel of one ``call()``, from torch.profiler:
    {name: [ms, launches]}."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    return {e.key: [e.self_device_time_total / 1e3, e.count]
            for e in prof.key_averages() if e.self_device_time_total > 0}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import numpy as np

    from cuda_ldpc_torch import NBCode, QCBinaryCode, cli
    from cuda_ldpc_torch.ops import (_build, channel, cuda_minsum, cuda_qspa,
                                     cuda_qspa_qc, demod, minsum, nb_decode)
    from cuda_ldpc_torch.utils.constellations import constellation
    from cuda_ldpc_torch.utils.device import card_info
    from cuda_ldpc_torch.utils.stats import rates_compatible

    wrappers = (cuda_minsum, cuda_qspa, cuda_qspa_qc)

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
    codes = {}

    def code_of(name):
        return codes.setdefault(name, QCBinaryCode.from_registry(name))

    def chan_for(code, snr_type, snr, batch, seed, rule="minsum"):
        sigma = channel.sigma_from_snr(snr, code.rate, snr_type)
        g = torch.Generator(device=dev).manual_seed(seed)
        cw = torch.zeros((code.L, code.Z), device=dev)
        chan = channel.bpsk_awgn_llr(g, cw, sigma, batch)
        # bp needs true LLRs, as the sweep's step gives it
        return chan.mul_(2.0 / (sigma * sigma)) if rule == "bp" else chan

    minsum_cases = [
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
    bp_cases = [
        ("J4_L24_Z96", "ebn0", 3.6, 4096, 50, "zero", True, 1.0, 0.0),
        ("J4_L24_Z96", "ebn0", 3.3, 11, 20, "syndrome", False, 0.8, 0.1),
        ("J15_L30_Z1280", "esn0", -1.6, 4096, 50, "zero", True, 1.0, 0.0),
        ("J15_L30_Z1280", "esn0", -1.6, 4096, 10, "syndrome", False, 1.0,
         0.0),
        ("PON_LDPC", "esn0", 2.3, 4096, 50, "syndrome", True, 1.0, 0.0),
        ("PON_LDPC", "esn0", 2.3, 512, 10, "none", False, 0.8, 0.1),
    ]
    cases = ([("flooding", "minsum", *c) for c in minsum_cases]
             + [("layered", "minsum", *c) for c in minsum_cases]
             + [(s, "bp", *c) for s in ("flooding", "layered")
                for c in bp_cases])
    max_err = {name: 0.0 for name, _, _ in KERNELS}
    mismatches = {name: 0 for name, _, _ in KERNELS}
    for i, (schedule, rule, name, st, snr, B, iters, check, early, alpha,
            beta) in enumerate(cases):
        code = code_of(name)
        chan = chan_for(code, st, snr, B, seed=100 + i, rule=rule)
        kw = dict(alpha=alpha, beta=beta, check=check, early_stop=early,
                  rule=rule)
        a = getattr(cuda_minsum, f"decode_{schedule}")(chan, code, iters, **kw)
        b = getattr(minsum, f"decode_{schedule}")(chan, code, iters, **kw)
        torch.cuda.synchronize()
        hard_diff = a.hard != b.hard
        counts = {"hard": int(hard_diff.sum()),
                  "hard_in_ok_frames": int(hard_diff[b.ok].sum()),
                  "ok": int((a.ok != b.ok).sum()),
                  "iters": abs(int(a.iters) - int(b.iters))}
        # the largest |kernel - plain| over hard, ok and iters
        err = max(int(hard_diff.any()), int(counts["ok"] > 0),
                  counts["iters"])
        key = f"{rule}_{schedule}"
        max_err[key] = max(max_err[key], float(err))
        mismatches[key] += counts["hard"] + counts["ok"]
        _emit("parity", kernel=key, code=name, snr=f"{st} {snr}", batch=B,
              iters=iters, check=check, early_stop=early, alpha=alpha,
              beta=beta, kernel_iters=int(a.iters), plain_iters=int(b.iters),
              frames_ok=int(a.ok.sum()), mismatches=counts, max_abs_err=err)
        # exact for both rules: the kernel's logf/tanhf and torch.log /
        # torch.tanh on the card agree to the last bit
        if counts["hard"] or counts["ok"] or counts["iters"]:
            raise AssertionError(f"kernel != plain on case {i}: {cases[i]}")
        del a, b, chan, hard_diff
    torch.cuda.empty_cache()

    # GF(q): K5 and K6 against the plain nb_decode on the same CUDA tensors
    nb_codes = {}

    def nb_code(name):
        return nb_codes.setdefault(name, NBCode.from_registry(name))

    def nb_chan(code, ebn0, batch, seed, n_qam=2):
        """Symbol LLRs of the all-zero codeword, BPSK or QAM + AWGN, as the
        nb sweep's source draws them."""
        sigma = channel.sigma_from_snr(ebn0, code.rate, "ebn0",
                                       float(np.log2(n_qam)))
        labels = np.zeros(code.bit_length if n_qam == 2 else code.n_sym,
                          dtype=np.int64)
        g = torch.Generator(device=dev).manual_seed(seed)
        return demod.nb_channel_llr(g, labels, constellation(n_qam), sigma,
                                    batch, code.q, device=dev)

    nb_pairs = {   # kernel name -> (wrapper, plain version)
        "qspa_flooding": (cuda_qspa.decode_flooding, nb_decode.decode_qspa),
        "qspa_layered": (cuda_qspa.decode_layered,
                         nb_decode.decode_layered_qspa),
        "qspa_qc_flooding": (cuda_qspa_qc.decode_flooding,
                             nb_decode.decode_qspa),
        "qspa_qc_layered": (cuda_qspa_qc.decode_layered,
                            nb_decode.decode_glayered_qspa),
    }
    k5_cases = [
        # code, Eb/N0, QAM order, batch, iterations, early stop
        ("BDS.576.288.GF.64", 1.0, 2, 4096, 20, True),
        ("BDS.576.288.GF.64", 2.0, 2, 4096, 20, True),
        ("BDS.576.288.GF.64", 1.5, 2, 11, 20, True),
        ("BDS.576.288.GF.64", 1.0, 2, 512, 20, False),
        ("BDS.576.288.GF.64", 1.0, 2, 64, 0, True),
        ("BDS.576.288.GF.64", 2.0, 64, 1024, 20, True),
        ("LDPC_N576_K288_GF64_d1_exp", 2.0, 2, 512, 20, True),
        ("LDPC_N96_K48_GF256_d1_exp", 2.0, 2, 1024, 20, True),
        ("LDPC_N96_K48_GF256_d1_exp", 12.0, 256, 1024, 20, True),
        ("LDPC_N576_K480_GF256_exp", 3.0, 2, 512, 20, True),
        ("LDPC_N576_K480_GF256_exp", 12.0, 256, 512, 20, True),
    ]
    k6_cases = [
        ("Tanner_74_9_Z128_GF16", 3.3, 2, 256, 20, True),
        ("Tanner_74_9_Z128_GF16", 4.3, 2, 256, 20, True),
        ("Tanner_74_9_Z128_GF16", 3.4, 2, 11, 20, False),
    ]
    nb_cases = ([(f"qspa_{s}", *c) for s in ("flooding", "layered")
                 for c in k5_cases]
                + [(f"qspa_qc_{s}", *c) for s in ("flooding", "layered")
                   for c in k6_cases])
    for i, (key, name, ebn0, n_qam, B, iters, early) in enumerate(nb_cases):
        code = nb_code(name)
        L = nb_chan(code, ebn0, B, seed=300 + i, n_qam=n_qam)
        kernel, plain = nb_pairs[key]
        a = kernel(L, code, iters, early_stop=early)
        b = plain(L, code, iters, early_stop=early)
        torch.cuda.synchronize()
        hard_diff = a.hard != b.hard
        counts = {"hard": int(hard_diff.sum()),
                  "hard_in_ok_frames": int(hard_diff[b.ok].sum()),
                  "ok": int((a.ok != b.ok).sum()),
                  "iters": int((a.iters != b.iters).sum())}
        # the largest |kernel - plain| over hard symbols, ok and iters
        err = max([int((a.hard - b.hard).abs().max()) if B else 0,
                   counts["ok"] > 0,
                   int((a.iters - b.iters).abs().max()) if B else 0])
        max_err[key] = max(max_err[key], float(err))
        mismatches[key] += counts["hard"] + counts["ok"] + counts["iters"]
        _emit("parity", kernel=key, code=name, ebn0=ebn0, n_qam=n_qam,
              batch=B, iters=iters, early_stop=early,
              frames_ok=int(b.ok.sum()),
              avg_iters=float(b.iters.float().mean()) if B else 0.0,
              mismatches=counts, max_abs_err=err)
        if counts["ok"] or counts["iters"] or counts["hard_in_ok_frames"]:
            raise AssertionError(f"kernel != plain on GF(q) case {i}: "
                                 f"{nb_cases[i]}")
        del a, b, L, hard_diff
    torch.cuda.empty_cache()

    # ---- 4. the main path, through the CLI
    keep = ("snr", "frames", "error_frames", "error_units", "fer", "ber",
            "avg_iters", "false_frames", "alarm_frames", "info_mbps")
    launches = {}

    def drive(tmp, label, kernel, argv):
        """One sweep with every launch count at 0 before it; the counts
        are read after it, and the named kernel must have launched."""
        for w in wrappers:
            for k in w.LAUNCHES:
                w.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        rows = _sweep(cli, os.path.join(tmp, label), argv)
        seconds = time.perf_counter() - t0
        counts = {k: v for w in wrappers for k, v in w.LAUNCHES.items()}
        if counts[kernel] <= 0:
            raise AssertionError(f"the {label} sweep never launched the "
                                 f"{kernel} kernel: {counts}")
        _emit("main_path", sweep=label, seconds=seconds, launches=counts,
              rows=[{k: r[k] for k in keep} for r in rows])
        if not all(r["frames"] > 0 and 0.0 <= r["fer"] <= 1.0 for r in rows):
            raise AssertionError(f"bad {label} rows: {rows}")
        return rows, counts[kernel]

    slower = []

    def no_slower(label, layered, flooding, required=True):
        """Layered's avg_iters against flooding's at each point; where
        ``required``, no larger, and a failure is raised once every sweep
        has run."""
        pairs = [(a["snr"], a["avg_iters"], b["avg_iters"])
                 for a, b in zip(layered, flooding)]
        holds = len(layered) == len(flooding) and all(la <= fl
                                                      for _, la, fl in pairs)
        _emit("layered_vs_flooding", sweep=label, required=required,
              holds=holds, snr_layered_flooding_avg_iters=pairs,
              fer_layered_flooding=[(a["fer"], b["fer"])
                                    for a, b in zip(layered, flooding)])
        if required and not holds:
            slower.append((label, pairs))

    def anchor(label, code_name, snr, r, ref):
        """A sweep row's FER against a reference count, Clopper-Pearson."""
        compatible = rates_compatible(r["error_frames"], r["frames"], *ref)
        _emit("fer_anchor", sweep=label, code=code_name, ebn0=snr,
              errors=r["error_frames"], frames=r["frames"], fer=r["fer"],
              reference=f"{ref[0]}/{ref[1]} = {ref[0] / ref[1]:.4g}",
              compatible=compatible)
        if not compatible:
            raise AssertionError(f"{label}: {code_name} FER at Eb/N0 {snr} "
                                 f"dB is not compatible with "
                                 f"{ref[0]}/{ref[1]}")

    j15 = ["binary", "--code", "J15_L30_Z1280", "--snr=-1.6:0.1:-1.4",
           "--snr-type", "esn0", "--max-iters", "50", "--batch", "4096",
           "--least-error-frames", "50", "--least-test-frames", "4096",
           "--max-frames", "12288"]
    pon = ["binary", "--code", "PON_LDPC", "--snr", "2.4:0.2:2.6",
           "--snr-type", "esn0", "--max-iters", "50", "--batch", "4096",
           "--least-error-frames", "50", "--least-test-frames", "4096",
           "--max-frames", "12288"]
    bds = ["nb", "--code", "BDS.576.288.GF.64", "--snr", "1", "--snr-type",
           "ebn0", "--max-iters", "20", "--batch", "4096",
           "--least-error-frames", "50", "--least-test-frames", "8192",
           "--max-frames", "8192"]
    # (the waterfall of the JAX package's own decoder lies at 3.2-3.6 dB;
    # VALIDATION.md:34's FER 0.81 at 4.2 dB is not what nb_decode gives)
    tanner = ["nb", "--code", "Tanner_74_9_Z128_GF16", "--snr", "3.2:0.2:3.6",
              "--snr-type", "ebn0", "--max-iters", "20", "--batch", "256",
              "--least-error-frames", "50", "--least-test-frames", "512",
              "--max-frames", "1024"]
    with tempfile.TemporaryDirectory() as tmp:
        rows, launches["minsum_flooding"] = drive(tmp, "j15", "minsum_flooding",
                                                  j15)
        if len(rows) != 3 or not all(r["frames"] >= 4096 for r in rows):
            raise AssertionError(f"bad J15_L30_Z1280 rows: {rows}")
        if not rows[0]["fer"] >= rows[-1]["fer"]:
            raise AssertionError("FER does not fall across the waterfall")
        lay, launches["minsum_layered"] = drive(
            tmp, "j15_layered", "minsum_layered", j15 + ["--schedule",
                                                         "layered"])
        # Unnormalised min-sum (alpha 1, the reference's rule) in the layered
        # schedule leaves more J15_L30_Z1280 frames unconverged than
        # flooding does; the JAX package's decode_layered gives the same
        # frames on this code (tests/test_torch_layered_bp.py).  A batch
        # keeps iterating while one frame fails, so the count is reported
        # here.  Normalised (alpha 0.8), which damps the overestimated
        # messages, layered is no slower, and that is required, as it is of
        # bp and of PON_LDPC.
        no_slower("j15 min-sum", lay, rows, required=False)
        norm = ["--alpha", "0.8"]
        flood08, _ = drive(tmp, "j15_a08", "minsum_flooding", j15 + norm)
        lay08, _ = drive(tmp, "j15_layered_a08", "minsum_layered",
                         j15 + norm + ["--schedule", "layered"])
        no_slower("j15 min-sum alpha 0.8", lay08, flood08)

        bp, launches["bp_flooding"] = drive(tmp, "j15_bp", "bp_flooding",
                                            j15 + ["--rule", "bp"])
        bp_lay, launches["bp_layered"] = drive(
            tmp, "j15_bp_layered", "bp_layered",
            j15 + ["--rule", "bp", "--schedule", "layered"])
        no_slower("j15 bp", bp_lay, bp)

        rows, _ = drive(tmp, "pon", "minsum_flooding", pon)
        if len(rows) != 2:
            raise AssertionError(f"bad PON_LDPC rows: {rows}")
        lay, _ = drive(tmp, "pon_layered", "minsum_layered",
                       pon + ["--schedule", "layered"])
        no_slower("pon min-sum", lay, rows)

        anchors = [
            ("j4", "minsum_flooding", [], 200, 40960, (33, 2021)),
            ("j4_bp", "bp_flooding", ["--rule", "bp"], 100, 65536,
             (72, 32768)),
        ]
        for label, kernel, extra, least_errors, max_frames, ref in anchors:
            rows, _ = drive(tmp, label, kernel, [
                "binary", "--code", "J4_L24_Z96", "--snr", "3.6",
                "--snr-type", "ebn0", "--max-iters", "50", "--check", "zero",
                "--batch", "4096", "--least-error-frames", str(least_errors),
                "--least-test-frames", "8192", "--max-frames",
                str(max_frames), *extra])
            anchor(label, "J4_L24_Z96", 3.6, rows[-1], ref)

        # GF(q): BDS.576.288.GF.64 at 1 dB against VALIDATION.md:21-22
        flood, launches["qspa_flooding"] = drive(
            tmp, "bds_qspa", "qspa_flooding", bds + ["--method", "qspa"])
        anchor("bds_qspa", "BDS.576.288.GF.64", 1.0, flood[-1], (598, 2304))
        lay, launches["qspa_layered"] = drive(
            tmp, "bds_layered_qspa", "qspa_layered",
            bds + ["--method", "layered_qspa"])
        anchor("bds_layered_qspa", "BDS.576.288.GF.64", 1.0, lay[-1],
               (872, 4096))
        no_slower("bds qspa", lay, flood)
        drive(tmp, "bds_qspa_64qam", "qspa_flooding",
              ["nb", "--code", "BDS.576.288.GF.64", "--method", "qspa",
               "--n-qam", "64", "--snr", "2", "--max-iters", "20", "--batch",
               "4096", "--least-error-frames", "50", "--least-test-frames",
               "8192", "--max-frames", "8192"])
        flood, launches["qspa_qc_flooding"] = drive(
            tmp, "tanner_qspa", "qspa_qc_flooding",
            tanner + ["--method", "qspa"])
        lay, launches["qspa_qc_layered"] = drive(
            tmp, "tanner_glayered_qspa", "qspa_qc_layered",
            tanner + ["--method", "glayered_qspa"])
        for label, rows in (("tanner qspa", flood),
                            ("tanner glayered_qspa", lay)):
            fers = [r["fer"] for r in rows]
            if len(rows) != 3 or fers != sorted(fers, reverse=True):
                raise AssertionError(f"{label}: FER rises across the "
                                     f"waterfall: {fers}")
        no_slower("tanner glayered qspa", lay, flood)
        # the pair with no kernel is refused on the card, naming the item
        try:
            _sweep(cli, os.path.join(tmp, "refused"),
                   tanner + ["--method", "layered_qspa"])
        except ValueError as e:
            if "ROADMAP.md Queue 1 item 13" not in str(e):
                raise
            _emit("refused", sweep="tanner layered_qspa", error=str(e))
        else:
            raise AssertionError("layered_qspa on Tanner_74_9_Z128_GF16 ran "
                                 "under kernel auto")

    # ---- 5. timing: 10 fixed iterations, one batch in flight
    code = codes["J15_L30_Z1280"]
    B, iters, reps = 4096, 10, {"kernel": 20, "plain": 5}
    timing = {}
    for name, _, _ in BINARY:
        rule, schedule = name.split("_")
        chans = [chan_for(code, "esn0", -1.5, B, seed=7 + i, rule=rule)
                 for i in range(2)]
        decoders = {"kernel": getattr(cuda_minsum, f"decode_{schedule}"),
                    "plain": getattr(minsum, f"decode_{schedule}")}

        def launch(which, i):
            return decoders[which](chans[i % 2], code, iters, check="zero",
                                   early_stop=False, rule=rule)

        runs = time_turns(launch, reps)
        ms = {k: statistics.median(v) for k, v in runs.items()}
        bound, bound_by = bound_ms(code, B, iters, schedule, rule, "zero")
        timing[name] = (ms, bound, bound_by)
        _emit("timing", kernel=name, code=code.name, batch=B, iters=iters,
              card=card, ms_per_batch=runs,
              info_mbps={k: B * code.k / (v / 1e3) / 1e6
                         for k, v in ms.items()},
              bound_ms=bound, bound_by=bound_by)
        # where the kernel's time goes: device time per CUDA kernel of one
        # decode call, from torch.profiler
        device_ms = profile_ms(lambda: launch("kernel", 0))
        _emit("profile", kernel=name, code=code.name, batch=B, iters=iters,
              card=card, device_ms_total=sum(v[0] for v in device_ms.values()),
              device_ms_launches=device_ms)
        del chans
        torch.cuda.empty_cache()

    # GF(q): at most 10 passes, early stop off, below the waterfall so that
    # most frames run every pass (each frame still stops when it passes)
    nb_timing = [
        # kernel, code, Eb/N0, batch, plain reps
        ("qspa_flooding", "BDS.576.288.GF.64", 0.0, 4096, 3),
        ("qspa_layered", "BDS.576.288.GF.64", 0.0, 4096, 3),
        ("qspa_qc_flooding", "Tanner_74_9_Z128_GF16", 3.0, 256, 3),
        ("qspa_qc_layered", "Tanner_74_9_Z128_GF16", 3.0, 256, 3),
    ]
    for name, code_name, ebn0, B, plain_reps in nb_timing:
        code = nb_code(code_name)
        chans = [nb_chan(code, ebn0, B, seed=17 + i) for i in range(2)]
        decoders = dict(zip(("kernel", "plain"), nb_pairs[name]))

        def launch(which, i):
            return decoders[which](chans[i % 2], code, iters,
                                   early_stop=False)

        runs = time_turns(launch, {"kernel": 20, "plain": plain_reps})
        ms = {k: statistics.median(v) for k, v in runs.items()}
        res = launch("kernel", 0)
        E = int(code.cn_weight.sum())
        bound, bound_by = qspa_bound_ms(code.n_sym, E, code.q, B,
                                        res.iters.tolist(), iters,
                                        name.endswith("layered"))
        timing[name] = (ms, bound, bound_by)
        info_bits = code.k_sym * code.q_bit
        _emit("timing", kernel=name, code=code.name, batch=B, ebn0=ebn0,
              max_passes=iters, avg_iters=float(res.iters.float().mean()),
              card=card, ms_per_batch=runs,
              info_mbps={k: B * info_bits / (v / 1e3) / 1e6
                         for k, v in ms.items()},
              bound_ms=bound, bound_by=bound_by)
        # one launch per call: CUDA events around it give its device time
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        launch("kernel", 0)
        events[1].record()
        events[1].synchronize()
        device_ms = profile_ms(lambda: launch("kernel", 0))
        _emit("profile", kernel=name, code=code.name, batch=B,
              max_passes=iters, card=card,
              event_ms=events[0].elapsed_time(events[1]),
              device_ms_total=sum(v[0] for v in device_ms.values()),
              device_ms_launches=device_ms)
        del chans, res
        torch.cuda.empty_cache()

    # ---- the kernels, the card, and the result
    if slower:
        raise AssertionError(f"layered avg_iters above flooding's: {slower}")
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "cuda_ldpc_tpu"))
    if leaked:
        raise AssertionError(f"the port imported {leaked[:5]}")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": max_err[name], "mismatches": mismatches[name],
        "ms": timing[name][0]["kernel"], "plain_ms": timing[name][0]["plain"],
        "bound_ms": timing[name][1], "bound_by": timing[name][2],
        "library_ms": None} for name, source, replaces in KERNELS]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
