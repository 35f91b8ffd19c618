"""Drive cuda_ldpc_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py          (from the root of the repository)

Phases, each printing JSON lines; any failure raises and exits non-zero:
  1. device   needs torch.cuda.is_available(); prints the card's name and
              power limit as nvidia-smi reports them
  2. build    builds every kernel in cuda_ldpc_torch/csrc/ with nvcc, one
              compiler per source, all at once
  3. parity   each kernel vs its plain PyTorch version on the same CUDA
              tensors.  Flooding and layered min-sum (K1, K2, each frame's
              state on chip): J4_L24_Z96 at B=4096, 37 and 11,
              J15_L30_Z1280 and PON_LDPC at B=4096, checks zero / syndrome
              / none, early stop on and off, alpha 0.8 with beta 0.1, 0
              iterations, and a crafted batch whose frames pass and then
              fail, so that the on-chip stop protocol's lockstep steps run.
              The bp rule in both schedules (K3) on true LLRs: J4_L24_Z96,
              J15_L30_Z1280 and PON_LDPC at the main path's B=4096, and
              smaller batches.  The bfloat16 forms of K1, K2 and K3 (T and
              R stored as bf16, float32 compute) against the plain
              version's bf16 storage: J4_L24_Z96 (the crafted batch among
              them), J15_L30_Z1280 and PON_LDPC at B=4096, checks zero /
              syndrome / none, early stop on and off, alpha 0.8 with beta
              0.1.  hard, ok and iters exactly equal; every mismatch is
              counted and printed.  GF(q) FFT-QSPA, flooding, layered and
              grouped-layered: K5 on BDS.576.288.GF.64 at the main path's
              B=4096 (BPSK, Eb/N0 1 and 2 dB, maxIT 20), a ragged batch of
              11, early stop off, 0 iterations and 64-QAM, and on
              LDPC_N576_K288_GF64_d1_exp, LDPC_N96_K48_GF256_d1_exp and
              LDPC_N576_K480_GF256_exp (BPSK and 256-QAM), hard, ok and
              iters exactly equal on every frame, and, where the dispatch
              rule puts a row on one warp, against a warp an edge: the
              same; K6 on Tanner_74_9_Z128_GF16 at B=256 in its
              waterfall (Eb/N0 3.3 dB, early stop on and off) and above it
              (4.3 dB), a ragged batch, and on synthetic fully QC codes
              over GF(4), GF(16) and GF(32): ok and iters exactly equal,
              hard exactly equal on frames whose check passed, every other
              difference counted, and against its global-memory design:
              hard, ok and iters identical on every frame
  4. main     the main path through the CLI, each sweep with every launch
              count set to 0 just before it and read just after: J15_L30_Z1280
              at B=4096, maxIT 50, around the waterfall, flooding and layered
              min-sum and bp; PON_LDPC flooding and layered min-sum; layered
              avg_iters no larger than flooding's at each point for bp, for
              PON_LDPC and for J15_L30_Z1280 min-sum with alpha 0.8
              (reported for J15_L30_Z1280 min-sum with alpha 1); J4_L24_Z96
              at Eb/N0 3.6 dB, min-sum and bp, whose FERs must be
              statistically compatible with the reference's 33/2021 and
              72/32768; the J15_L30_Z1280 sweeps again with --msg-dtype
              bfloat16 (flooding and layered min-sum and bp, and flooding
              min-sum --packed), whose counts must show the bf16 kernels
              and no float32 one, FER compatible with float32's at each
              point, and `--engine stream --msg-dtype bfloat16` refused by
              design.  GF(q): `nb` qspa and layered_qspa on
              BDS.576.288.GF.64 at Eb/N0 1 and 2 dB, maxIT 20, B=4096 (K5
              with a row on one warp: its counts by design show it for
              both schedules), compatible with VALIDATION.md:21-22,
              layered avg_iters no larger; a 64-QAM qspa sweep at 2 dB;
              Tanner_74_9_Z128_GF16 qspa and glayered_qspa across its
              waterfall, Eb/N0 3.2:0.2:3.6, B=256, FER not rising,
              glayered avg_iters no larger, and layered_qspa there (K6's
              block-row schedule: its row groups are its block rows in
              row order), whose rows must equal glayered_qspa's;
              glayered_tmm (K8) and glayered_qspa (K5) on BDS at 1 and 2
              dB, 2048 frames a point, with no plain decode, whose rows
              must equal the same sweeps' under --kernel torch
  5. timing   J15_L30_Z1280, B=4096, 10 fixed iterations, one batch in
              flight: each binary kernel, its bfloat16 form and both plain
              PyTorch versions in turns (plain, plain bf16, kernel, bf16,
              bf16, kernel, plain bf16, plain), then one call of each form
              under torch.profiler for its device time per CUDA kernel; K1
              and K2 min-sum on PON_LDPC in turns; the
              same for K5 on BDS.576.288.GF.64 at B=4096 and K6 on
              Tanner_74_9_Z128_GF16 at B=256, at most 10 passes, early stop
              off, at an Eb/N0 where most frames run every pass (K5: the
              kernel, a warp an edge where the rule puts a row on one warp
              and the plain version in turns, grouped-layered also beside
              the serial-row layered kernel; K6: the staged kernel, its
              global-memory design and the plain version in turns)
The stream steps K4 (binary) and K7 (GF(q)) join each phase:
  parity      K4 against its plain version over a call sequence (k = 1,
              refill, k = 16, refill, drain k = max_iters + 1) on
              J4_L24_Z96, PON_LDPC and J15_L30_Z1280 at B=4096, both
              schedules, both rules, checks zero and syndrome (alpha 0.8
              with beta 0.1 on syndrome, and on zero for min-sum too), and
              a ragged batch of 37: every output and state tensor exactly
              equal; K4's min-sum (the slot's state on chip) also against
              the global-memory design on the same sequences.  K7
              the same on BDS.576.288.GF.64 at B=4096, a ragged 37 and
              B=512 at Eb/N0 0, 2 and 4 dB, and the other three adjacency
              codes, flooding, layered and grouped-layered: every output
              and state tensor exactly equal
  main        `binary --engine stream` on J15_L30_Z1280 (flooding min-sum,
              layered min-sum alpha 0.8, flooding bp), FER compatible with
              the batch sweeps at the same points; `binary --packed` on
              PON_LDPC's committed grid (Es/N0 0:0.2:13, maxIT 50, >=50
              errors and >=10k frames, 20k-frame cap), compatible with
              VALIDATION.md:173-174; `binary --packed --engine stream` on
              J15_L30_Z1280; `nb --engine stream` on BDS qspa,
              layered_qspa and glayered_qspa at Eb/N0 1 and 2 dB (1 dB
              compatible with the batch sweeps' rows and, but for
              glayered_qspa, with VALIDATION.md:21-22), `nb --packed` and
              `nb --packed --engine
              stream`; a binary stream sweep killed and resumed, whose rows
              equal the uninterrupted run's; a pair K7 does not run refused
  timing      K4, J15_L30_Z1280 and PON_LDPC, B=4096, one call of 10
              passes where no slot converges: flooding and layered min-sum
              with the state on chip, the global-memory design and the
              plain version in turns (J15_L30_Z1280 flooding also on a
              cluster of 4 with chan on chip), flooding bp with its plain
              version; K7, BDS, B=4096, 10 passes at 0 dB from fresh slots,
              flooding, layered and grouped-layered, the kernel and the
              plain version in turns; the refill of one call; the
              stream sweeps' throughput beside the batch sweeps'
The max-domain decoder K8 (EMS Nm=2/Nc=2, EMS at other Nm/Nc, full EMS,
TMM, layered TMM, grouped-layered TMM) joins each phase:
  parity      K8 against its plain version, each method on the four
              adjacency codes: BDS.576.288.GF.64 at B=4096 where most
              frames converge and where few do, a ragged 37, B=512 at Eb/N0
              0, 2 and 4 dB, max_iters 0, 1 and 20 (layered TMM, whose
              plain version costs ~0.6 s a pass, in one case a code at 8
              passes, BDS's ragged batch at 20 and the batches of 0 and 1
              pass); full EMS at the same
              points with its batch cut to 1024 on GF(64) and 64 on GF(256)
              (its plain version holds [B, M, q, q] per convolution); EMS at
              other Nm/Nc (the mode ems_nmnc) against the plain EMS at the
              same Nm/Nc: every branch (conf(q,1) alone, the pairs, the
              chains, the budgeted chains at Nc = 3 to 10 on
              LDPC_N576_K480_GF256_exp, listed and dense messages, the
              most levels at Nc = 6), ties on
              LDPC_N576_K288_GF64_d1_exp, zero and random codewords,
              max_iters 0, 1, 3 and 20, a ragged batch; hard, ok and iters
              exactly equal; full EMS's and EMS at Nm/Nc's earlier designs
              (the yardstick, ``decode_ems_full_dense`` and
              ``decode_ems_nmnc_dense``) against the same plain results
  main        `nb` with no --method (ems) on BDS at Eb/N0 1 and 2 dB, then
              tmm, layered_tmm and ems_full, FER compatible with
              VALIDATION.md:19, 23, 24 and 20 (ems_full: 2048 frames a
              point); `nb --nm 64 --nc 3` (2048 frames a point, FER
              compatible with full EMS's VALIDATION.md:20: the same
              function but for rounding) and `--nm 16 --nc 2`, each with
              no plain decode; `nb --packed` ems; `nb --engine stream
              --method ems`, `nb --method ems_full`, `nb --nm 4` and `nb
              --method glayered_tmm` on Tanner_74_9_Z128_GF16 refused on
              the card, naming their ROADMAP items; the committed GF(q)
              workload (ems, maxIT 20, Eb/N0 0:0.5:5, >=50 errors and
              >=1000 frames) as one packed
              sweep with a frame cap, each point reported as stopped by the
              rule or by the cap
  timing      K8, BDS, B=4096, at most 10 passes at 0 dB from fresh frames,
              each method's kernel and plain version in turns
              (grouped-layered TMM also beside the serial-row layered TMM
              kernel; EMS at Nm/Nc 16/2 and 64/3; and 8/10, budgeted, on
              LDPC_N576_K480_GF256_exp at B=64; full EMS and EMS at Nm/Nc
              also beside their earlier designs, the yardstick, in turns)
Random codewords (the sources of `--tx random`, models/encoder.py) join
each phase:
  parity      cases of the tables above whose channel comes from the
              sweeps' own sources under tx='random' (chan_for, nb_chan):
              K1/K2 min-sum (early stop on and off) and bp on J4_L24_Z96
              and PON_LDPC at B=4096 with the syndrome check; K5 on BDS
              (BPSK and 64-QAM) at B=4096, K6 on Tanner_74_9_Z128_GF16 at
              B=256, K7 over its call sequence on BDS, K8 (EMS, full EMS,
              TMM, layered and grouped-layered TMM) on BDS; each as exact
              as on the all-zero
              word.  K4 on PON_LDPC as the stream engine runs it (refills
              of channel and codeword, the drain), against the same engine
              over the plain step, every counter and state tensor after
              every call.  The device encode of a PON_LDPC and a
              BDS.576.288.GF.64 batch at B=4096 and of its first 16
              frames: the numpy encode's codewords on the first 64 frames,
              H c = 0 on every frame
  main        J8_L24_Z96 at Eb/N0 2.53 dB, `--tx zero` and `--tx random
              --check syndrome`, 32768 frames each, compatible with each
              other and with VALIDATION.md:61-64; PON_LDPC at Es/N0
              2.4:0.2:2.6, batch and `--engine stream`, compatible with
              the zero word's batch rows; `nb --tx random` qspa on BDS at 1
              and 2 dB (VALIDATION.md:21-22), with `--engine stream`, with
              `--packed` (layered_qspa) and with ems (VALIDATION.md:19)
  timing      PON_LDPC and BDS at B=4096: the encode (message draw and
              product) beside the same batch's decode
              (K1 min-sum, maxIT 50, syndrome, Es/N0 2.5 dB; K5 qspa,
              maxIT 20, Eb/N0 2 dB), in turns
The measuring path and the probes K9-K11 (phase 6), each entry point run
with every launch count at 0 before it and read after it:
  bench       `python -m cuda_ldpc_torch.bench`'s run three times (K1) and
              once with BENCH_KERNEL=torch, each line and the spread; twice
              with BENCH_DTYPE=bfloat16 (K1's bf16 form, its own metric)
  profile     `binary --profile` on J15_L30_Z1280 (two points) and on
              J4_L24_Z96 (eleven points in one process), and `nb
              --profile` on BDS.576.288.GF.64, qspa and ems (one point
              each): each trace holds K1's, K5's or K8's device events by
              name, the device's busy share of each traced batch is
              printed, the rows equal an untraced run's; `--packed
              --profile` is refused
  phases      `python -m cuda_ldpc_torch.tools.profile_phases`' measure
  probes      each K9/K10 function and each K11 chain (every op class,
              n_par 1 and 4, K = 1 and 37) against its plain version,
              exactly (dot3 and trans within 1e-6 relative); the SASS check
              that no K11 chain was folded; the probes' entry points (K11:
              its rate table, per SM and per card); each probe's time, plain
              time and bound (dot3 beside torch.matmul without TF32, roll2
              beside torch.roll: 11 turns each, the medians, and each
              one's device time a call from a fresh process)
Each of phases 3-6 ends with a ``phase_seconds`` line (the measuring path
and the probes apart).  The last lines are the card line, the kernels'
JSON and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
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
    # the bfloat16 storage forms of K1, K2 and K3 (pallas_minsum.py:344)
    ("minsum_flooding_bf16", "cuda_ldpc_torch/csrc/minsum_flooding.cu",
     "cuda_ldpc_tpu/ops/pallas_minsum.py:251"),
    ("minsum_layered_bf16", "cuda_ldpc_torch/csrc/minsum_layered.cu",
     "cuda_ldpc_tpu/ops/pallas_minsum.py:299"),
    ("bp_flooding_bf16", "cuda_ldpc_torch/csrc/minsum_flooding.cu",
     "cuda_ldpc_tpu/ops/pallas_minsum.py:134"),
    ("bp_layered_bf16", "cuda_ldpc_torch/csrc/minsum_layered.cu",
     "cuda_ldpc_tpu/ops/pallas_minsum.py:134"),
    ("qspa_flooding", "cuda_ldpc_torch/csrc/qspa.cu",
     "cuda_ldpc_tpu/ops/pallas_qspa.py:302"),
    ("qspa_layered", "cuda_ldpc_torch/csrc/qspa.cu",
     "cuda_ldpc_tpu/ops/pallas_qspa.py:302"),
    ("qspa_qc_flooding", "cuda_ldpc_torch/csrc/qspa_qc.cu",
     "cuda_ldpc_tpu/ops/pallas_qspa_qc.py:326"),
    ("qspa_qc_layered", "cuda_ldpc_torch/csrc/qspa_qc.cu",
     "cuda_ldpc_tpu/ops/pallas_qspa_qc.py:326"),
    ("minsum_stream", "cuda_ldpc_torch/csrc/minsum_stream.cu",
     "cuda_ldpc_tpu/ops/pallas_minsum_stream.py:54"),
    ("qspa_stream", "cuda_ldpc_torch/csrc/qspa_stream.cu",
     "cuda_ldpc_tpu/ops/pallas_qspa_stream.py:136"),
    ("nbms_ems", "cuda_ldpc_torch/csrc/nbms.cu",
     "cuda_ldpc_tpu/ops/pallas_nbms.py:376"),
    ("nbms_tmm", "cuda_ldpc_torch/csrc/nbms.cu",
     "cuda_ldpc_tpu/ops/pallas_nbms.py:376"),
    ("nbms_layered_tmm", "cuda_ldpc_torch/csrc/nbms.cu",
     "cuda_ldpc_tpu/ops/pallas_nbms.py:376"),
    # full EMS and EMS at other Nm/Nc have no TPU kernel: the JAX package
    # runs them in jnp
    ("nbms_ems_full", "cuda_ldpc_torch/csrc/nbms.cu",
     "cuda_ldpc_tpu/ops/nb_decode.py:371"),
    ("nbms_ems_nmnc", "cuda_ldpc_torch/csrc/nbms.cu",
     "cuda_ldpc_tpu/ops/nb_decode.py:223"),
    # the grouped-layered schedule has no TPU kernel: the JAX package runs
    # its step in jnp
    ("nbms_glayered_tmm", "cuda_ldpc_torch/csrc/nbms.cu",
     "cuda_ldpc_tpu/ops/nb_decode.py:603"),
    ("qspa_glayered", "cuda_ldpc_torch/csrc/qspa.cu",
     "cuda_ldpc_tpu/ops/nb_decode.py:603"),
    ("qspa_stream_glayered", "cuda_ldpc_torch/csrc/qspa_stream.cu",
     "cuda_ldpc_tpu/ops/nb_decode.py:603"),
    # the probes, on the measuring path (phase 6)
    ("probe_bitops", "cuda_ldpc_torch/csrc/probe_bitops.cu",
     "tools/probe_bitops.py:28"),
    ("probe_mosaic", "cuda_ldpc_torch/csrc/probe_mosaic.cu",
     "tools/probe_mosaic.py:32"),
    ("probe_oprate", "cuda_ldpc_torch/csrc/probe_oprate.cu",
     "tools/probe_oprate.py:122"),
]
BINARY = KERNELS[:4]
# The earlier designs of two K8 modes, timed and held to the plain version
# beside them; no path of the port launches them.
YARDSTICKS = {"nbms_ems_full": "nbms_ems_full_dense",
              "nbms_ems_nmnc": "nbms_ems_nmnc_dense"}
# The K11 chains of the kernels line: every op class, n_par 1, this many
# steps (the rate table itself takes K = 50,000 and 250,000)
K11_LINE_STEPS = 1000


_START = time.perf_counter()


def _emit(phase: str, **kw):
    """One JSON line of a phase, with the seconds since the script began."""
    print(json.dumps({"phase": phase,
                      "seconds_in": round(time.perf_counter() - _START, 1),
                      **kw}), flush=True)


def _sweep(cli, out_dir: str, argv: list[str]) -> list[dict]:
    """One `python -m cuda_ldpc_torch binary|nb ...` run, in process; argv
    starts with the subcommand."""
    rc = cli.main([argv[0], "--device", "cuda", "--out-dir", out_dir,
                   "--display-step", str(10**12), "--quiet", *argv[1:]])
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}")
    with open(os.path.join(out_dir, "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def synthetic_qc_code(q: int, NB: int = 6, MB: int = 2, Z: int = 128,
                      seed: int = 0):
    """A random fully quasi-cyclic GF(q) code (the layout of
    tests/test_pallas_qspa_qc.py's synthetic code): every block row meets
    every block column in one full circulant of a random shift, with a
    random nonzero coefficient per check row."""
    import numpy as np

    from cuda_ldpc_torch import NBCode
    from cuda_ldpc_torch.utils.io import NBCodeFile
    rng = np.random.default_rng(seed)
    N, M = NB * Z, MB * Z
    cn_links = np.zeros((M, NB), np.int64)
    cn_gf = np.zeros((M, NB), np.int64)
    vn_links = np.zeros((N, MB), np.int64)
    vn_gf = np.zeros((N, MB), np.int64)
    for r in range(MB):
        for c in range(NB):
            s = int(rng.integers(0, Z))
            h = rng.integers(1, q, size=Z)
            for z in range(Z):
                v = c * Z + (z + s) % Z
                cn_links[r * Z + z, c], cn_gf[r * Z + z, c] = v, h[z]
                vn_links[v, r], vn_gf[v, r] = r * Z + z, h[z]
    return NBCode.from_file(NBCodeFile(
        N, M, q, MB, NB, np.full(N, MB), np.full(M, NB), vn_links, vn_gf,
        cn_links, cn_gf), name=f"synthetic_gf{q}")


def bound_ms(code, batch: int, iters: int, schedule: str, rule: str,
             check: str, bf16: bool = False) -> tuple[float, str]:
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
    one compare per message bit, the syndrome check one XOR per edge.
    ``bf16``: T and R stored as bfloat16 add one rounding for each total
    stored (flooding: each total per iteration; layered: one per edge and
    iteration, and the start's totals) and for each message the function
    must round: bp's per edge and CN update, min-sum's two per check node
    and CN update (rounding to nearest even is symmetric in the sign, so a
    stored message is its sign on bf16(v1) or bf16(v2)); widening a stored
    value to float32 is a shift and is not counted.  The bytes are the
    function's and do not change: T and R are its own state, not its
    inputs or outputs."""
    lanes = batch * code.num_edges * code.Z
    cn = {"minsum": 6, "bp": 17}[rule]
    # messages rounded per CN update when stored as bf16
    rounded = (lanes if rule == "bp" else 2 * batch * code.J * code.Z) \
        * bool(bf16)
    if schedule == "flooding":
        ops = lanes * (iters + cn * (iters - 1)) + rounded * (iters - 1)
        ops += batch * code.n * iters * bool(bf16)
    else:
        ops = (lanes * (cn + 2 + bool(bf16)) + rounded) * iters
        ops += batch * code.n * bool(bf16)
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
    value at 0), and 2 more for layered's total update (``layered``: the
    serial-row or the grouped-layered schedule, the same rows in another
    order); per pass, 1 compare per VN and symbol for the decision and, for
    flooding, 1 add per edge and symbol plus 1 per VN and symbol for the
    totals."""
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


def stream_bound_ms(code, batch: int, passes: int, updates: int,
                    layered: bool, rule: str, check: str) -> tuple[float, str]:
    """The least time the card could take for one K4 call whose slots ran
    ``passes`` decides and ``updates`` check-node phases in all: the larger
    of its bytes (chan read once, and written once when layered; R read
    once and written once; hard written once; t, done and okf read and
    written once) over the HBM rate and its fp32 operations, counted as in
    ``bound_ms`` (flooding's VN one add per edge and pass; the CN per edge
    and update; layered's total update 2 per edge and update; the check
    per pass), over the fp32 peak."""
    edges = code.num_edges * code.Z
    cn = {"minsum": 6, "bp": 17}[rule] + (2 if layered else 0)
    ops = updates * edges * cn + (0 if layered else passes * edges)
    ops += passes * {"zero": code.k, "syndrome": edges, "none": 0}[check]
    nbytes = (batch * code.n * 4 * (2 if layered else 1)
              + batch * edges * 4 * 2 + batch * code.n + batch * 4 * 3 * 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def qspa_stream_bound_ms(N: int, E: int, q: int, batch: int, passes: int,
                         updates: int, layered: bool) -> tuple[float, str]:
    """The least time the card could take for one K7 call whose slots ran
    ``passes`` decides and ``updates`` check-row phases in all: the larger
    of its bytes (chan [B, N, q] f32 read once, and written once when
    layered; C [B, E, q] read once and written once; hard [B, N] i32
    written once; t, done and okf read and written once) over the HBM rate,
    and its fp32 operations counted as in ``qspa_bound_ms``, over the fp32
    peak."""
    import math
    lq = int(math.log2(q))
    ops = updates * E * q * (13 + 2 * lq + (2 if layered else 0))
    ops += passes * N * q * (1 if layered else 2)
    if not layered:
        ops += passes * E * q
    nbytes = (batch * N * q * 4 * (2 if layered else 1) + batch * E * q * 4 * 2
              + batch * N * 4 + batch * 4 * 3 * 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def nbms_bound_ms(N: int, M: int, E: int, q: int, batch: int, iters,
                  max_iters: int, method: str, nm: int = 2,
                  nc: int = 2) -> tuple[float, str]:
    """The least time the card could take for one K8 decode call that gave
    per-frame iteration counts ``iters``: the larger of the bytes it must
    move (chan [B, N, q] f32 read once; hard [B, N] i32, ok [B] and iters
    [B] i32 written once) over the HBM rate, and the function's fp32
    operations over the fp32 peak.  Updates and passes per frame as in
    ``qspa_bound_ms``.  Each fp32 add, subtract, multiply, fma, compare,
    max, min or select of a value counts as one; index and GF table
    arithmetic, integer compares and selects of indices do not; rows are
    full, dc = E / M.  EMS, per edge and symbol and update: 1 (v2c) + 2 (a
    maximum and the compare that finds its first index) + 1 (W) + 2 (the
    best non-zero offset) + (dc - 2) (the best single deviation of the
    other edges) + 2 (output); per row, an add for each pair of edges, and
    per edge a max for each pair of the other edges.  TMM, per edge and
    symbol: 1 (v2c) + 2 (a minimum and its first index) + 1 (dU) + 4
    (min1, min2 and the compare for the column) + 3 (the I/E select, the
    zero at eta = 0, the 0.8), and 3 more for layered's write-back
    (grouped-layered TMM is the same work: the same rows, in another
    order); per row, the 2-deviation search over its q(q - 1)/2 unordered
    candidates {j, eta ^ j} (the candidate and its validity are symmetric
    in the two, so the first j of a pair decides), 4 each (the value
    compare, the max, the compare with the best so far and its select),
    and 3 per eta for
    the I/E choice.  Per pass, 2 per VN and symbol for the decision and,
    flooding, the totals' dv adds per VN and symbol (E q in all).  Full
    EMS, per row: the (max,+) convolutions out[x] = max_u A[u] + B[u ^ x]
    the function needs, 2 q^2 each (an add and a max a term): dc - 2 for
    the prefixes U[0] * ... * U[k], k = 1 .. dc - 2, dc - 2 for the
    suffixes U[k] * ... * U[dc - 1], k = 1 .. dc - 2, and dc - 2 for the
    inner edges' exclusive values (a prefix with a suffix; the end edges'
    are a suffix and a prefix already), 3 dc - 6 in all (the plain version
    and the kernel do 3 dc - 2, those with the identity too); per edge and
    symbol, 1 (v2c) and 2 (the output's subtract and multiply).  EMS at
    (nm, nc) (the mode ems_nmnc), with K = min(nm - 1, q - 1) non-zero
    offsets an edge may deviate to: EMS's per edge and symbol without its
    best non-zero offset, 6 + (dc - 2); then the branch the plain version
    takes (csrc/nbms.cu ems_branch).  But for conf(q,1) alone, the top
    nm - 1 of q offsets per edge, a tournament's q + (k - 1) ceil(log2 q)
    compares with k = min(nm - 1, q - nm + 1) (the top ones, or the last
    ones left out; none when every offset is taken).  The pairs (nc = 2):
    per row an add for each pair of edges and pair of their offsets,
    C(dc, 2) K^2, and per edge a max for each of those of the pairs of
    other edges, C(dc - 1, 2) K^2.  The chains (nc >= dc - 1): per edge
    and symbol 2 (the message's max with the identity, D's max with the
    chains); per row 2 (dc - 2) prefixes and suffixes against a message of
    K + 1 values, 2 q (K + 1) each, and dc - 2 exclusive convolutions of
    2 q^2.  The budgeted chains (3 <= nc <= dc - 2): per edge and symbol 1
    (D's max); per row, as for full EMS, no term with the identity (level
    0, and the states of no message), and no level or term another one
    equals or dominates: a state of s messages equals its level s above
    it (F_s[c] = F_s[s] for c > s, by induction), the levels rise (F_s[c]
    >= F_s[c - 1] elementwise, and a (max,+) convolution keeps the order),
    so an inner edge d, with d messages before it and dc - 1 - d after,
    needs only the terms maxconv(F_d[c], Bk_d[nc - c]) with nc - (dc - 1 -
    d) <= c <= d, those with 0 < c < nc convolutions of 2 q^2 and the
    rest free, their maxes q each, and a state of s messages only its
    levels max(1, nc - (dc - 1 - s)) .. min(s, nc), each a max of q and,
    above level 1, a convolution against K values, 2 q K (an end edge's
    value is the top level of its chain's last state)."""
    iters = [int(i) for i in iters]
    updates = sum(min(i, max_iters - 1) for i in iters)
    passes = sum(min(i + 1, max_iters) for i in iters)
    dc = E // M
    if method == "ems":
        per_update = (E * q * (8 + dc - 2) + M * dc * (dc - 1) // 2
                      + E * (dc - 1) * (dc - 2) // 2)
    elif method == "ems_full":
        per_update = M * (3 * dc - 6) * 2 * q * q + E * q * 3
    elif method == "ems_nmnc":
        K = min(nm - 1, q - 1)
        per_update = E * q * (6 + dc - 2)
        branch = ("conf1" if nc < 2 or nm < 2 or dc < 3 else "pairs"
                  if nc == 2 else "chains" if nc >= dc - 1 else "budget")
        k = min(nm - 1, q - nm + 1)
        if branch != "conf1" and k > 0:
            per_update += E * (q + (k - 1) * (q - 1).bit_length())
        if branch == "pairs":
            per_update += (M * dc * (dc - 1) // 2 * K * K
                           + E * (dc - 1) * (dc - 2) // 2 * K * K)
        elif branch == "chains":
            per_update += (E * q * 2 + M * 2 * (dc - 2) * 2 * q * (K + 1)
                           + M * (dc - 2) * 2 * q * q)
        elif branch == "budget":
            chains = 2 * sum(q + (2 * q * K if c > 1 else 0)
                             for s in range(1, dc)
                             for c in range(max(1, nc - (dc - 1 - s)),
                                            min(s, nc) + 1))
            excl = 0
            for d in range(1, dc - 1):
                lo, hi = max(0, nc - (dc - 1 - d)), min(d, nc)
                excl += (hi - lo) * q + sum(2 * q * q
                                            for c in range(lo, hi + 1)
                                            if 0 < c < nc)
            per_update += E * q + M * (chains + excl)
    else:
        layered = method in ("layered_tmm", "glayered_tmm")
        per_update = (E * q * (11 + (3 if layered else 0))
                      + M * (4 * q * (q - 1) // 2 + 3 * q))
    ops = updates * per_update + passes * 2 * N * q
    if method not in ("layered_tmm", "glayered_tmm"):
        ops += passes * E * q
    nbytes = batch * N * q * 4 + batch * N * 4 + batch * 5
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def time_turns(launch, reps: dict,
               order=("plain", "kernel", "kernel", "plain")) -> dict:
    """Milliseconds per batch of ``launch(which, i)`` for each ``which`` of
    ``reps``, in the turns of ``order`` (by default plain, kernel, kernel,
    plain): host clock, one batch in flight, device synchronised.  Each
    turn is warmed up by one call first, except a caller timed once a turn
    (a plain version whose call takes seconds, already run in the parity
    phase)."""
    import torch

    def time_one(which: str) -> float:
        def go(i):
            res = launch(which, i)
            ev = torch.cuda.Event()
            ev.record()
            return res, ev

        if reps[which] > 1:
            go(0)[1].synchronize()                       # warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prev = go(0)
        for i in range(1, reps[which]):
            nxt = go(i)
            prev[1].synchronize()         # wait for batch i-1 while i runs
            prev = nxt
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps[which]

    runs = {which: [] for which in reps}
    for which in order:
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


def trace_busy(path: str, label: str) -> dict:
    """What a --profile trace holds: the traced batch's window (the
    record_function span ``label``), the device's busy share of it (the
    union of the CUDA kernels' intervals, clipped to the window, over its
    length) and the launches of each kernel by name."""
    from collections import Counter
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation" and e.get("name") == label]
    if len(span) != 1:
        raise AssertionError(f"{path}: no single span {label!r}")
    t0, t1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel"]
    busy, end = 0.0, t0
    for a, b in sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                       for e in kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"window_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (t1 - t0),
            "kernels": dict(Counter(
                e["name"].replace("(anonymous namespace)::", "").split("(")[0]
                for e in kernels))}


def measuring_path(card: str, wrappers) -> None:
    """Phase 6: the port's measuring path through its entry points, each
    run with every launch count at 0 before it and read after it: the
    bench (three kernel lines, one plain and two of K1's bfloat16 form),
    --profile on the batch
    engines (binary J15_L30_Z1280 at two points and J4_L24_Z96 at eleven,
    nb BDS qspa and ems at one), whose traces must hold K1's, K5's and K8's
    device events by name, every point's, and whose rows must equal an
    untraced run's, --packed --profile refused, and profile_phases.  Each traced sweep runs as `python -m
    cuda_ldpc_torch ... --profile DIR` in a process of its own: a process
    that has run many kernels between a few earlier traces (as this one
    has) records no kernels in its later traces, a fresh one records them
    all; the untraced sweep it is compared with runs here, counted."""
    import statistics
    import subprocess

    from cuda_ldpc_torch import bench, cli
    from cuda_ldpc_torch.tools import profile_phases

    def counted(kernel: str, run):
        for w in wrappers:
            for k in w.LAUNCHES:
                w.LAUNCHES[k] = 0
        out = run()
        counts = {k: v for w in wrappers for k, v in w.LAUNCHES.items()}
        if counts[kernel] <= 0:
            raise AssertionError(f"{kernel} never launched: {counts}")
        return out, counts

    lines = []
    for kernel in ("auto", "auto", "auto", "torch"):
        if kernel == "auto":
            line, counts = counted("minsum_flooding", lambda: bench.run(
                {"BENCH_KERNEL": kernel}))
        else:                          # the plain path launches no kernel
            line, counts = bench.run({"BENCH_KERNEL": kernel}), None
        if line["metric"] != "binary_minsum_info_mbps_cuda" or not (
                line["value"] > 0):
            raise AssertionError(f"bad bench line: {line}")
        print(json.dumps(line), flush=True)
        lines.append((line, counts))
    values = [ln["value"] for ln, _ in lines[:3]]
    _emit("bench", card=card, kernel_mbps=values,
          spread=(max(values) - min(values)) / statistics.median(values),
          plain_mbps=lines[3][0]["value"],
          launches=lines[0][1]["minsum_flooding"])
    # T and R in bfloat16: K1's bf16 form, under a metric of its own
    bf16 = []
    for _ in range(2):
        line, counts = counted("minsum_flooding_bf16", lambda: bench.run(
            {"BENCH_DTYPE": "bfloat16"}))
        if (line["metric"] != "binary_minsum_bf16_info_mbps_cuda"
                or not line["value"] > 0 or counts["minsum_flooding"]):
            raise AssertionError(f"bad bf16 bench line: {line} {counts}")
        print(json.dumps(line), flush=True)
        bf16.append(line["value"])
    _emit("bench_bf16", card=card, kernel_mbps=bf16,
          float32_kernel_mbps=values,
          launches=counts["minsum_flooding_bf16"])

    keep = ("snr", "frames", "error_frames", "error_units", "iter_sum",
            "false_frames", "alarm_frames")
    frames = ["--batch", "4096", "--least-error-frames", "0",
              "--least-test-frames", "8192", "--max-frames", "8192"]
    sweeps = [
        ("binary", "minsum_flooding", "onchip_batch_kernel",
         ["binary", "--code", "J15_L30_Z1280", "--snr=-1.6:0.2:-1.4",
          "--snr-type", "esn0", "--max-iters", "10"]),
        ("nb qspa", "qspa_flooding", "qspa_warp_kernel",
         ["nb", "--code", "BDS.576.288.GF.64", "--method", "qspa", "--snr",
          "1", "--max-iters", "20"]),
        ("nb ems", "nbms_ems", "nbms_kernel",
         ["nb", "--code", "BDS.576.288.GF.64", "--method", "ems", "--snr",
          "1", "--max-iters", "20"]),
        # eleven points in one process: every point's trace holds K1
        ("binary J4 11 points", "minsum_flooding", "onchip_batch_kernel",
         ["binary", "--code", "J4_L24_Z96", "--snr", "1:0.25:3.5",
          "--snr-type", "ebn0", "--max-iters", "10"]),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, kernel, name, argv) in enumerate(sweeps):
            tdir = os.path.join(tmp, f"trace{i}")
            out = os.path.join(tmp, f"traced{i}")
            subprocess.run(
                [sys.executable, "-m", "cuda_ldpc_torch", argv[0], "--device",
                 "cuda", "--out-dir", out, "--display-step", str(10**12),
                 "--quiet", *argv[1:], *frames, "--profile", tdir],
                check=True, cwd=os.path.dirname(os.path.abspath(__file__)))
            with open(os.path.join(out, "results.jsonl")) as f:
                traced = [json.loads(line) for line in f]
            plain, counts = counted(kernel, lambda: _sweep(
                cli, os.path.join(tmp, f"untraced{i}"), argv + frames))
            same = ([{k: r[k] for k in keep} for r in traced]
                    == [{k: r[k] for k in keep} for r in plain])
            for r in traced:
                point = f"{argv[0]}_snr{r['snr']:g}"
                got = trace_busy(os.path.join(tdir, point, "trace.json"),
                                 point)
                held = sum(v for k, v in got["kernels"].items() if name in k)
                _emit("profile_trace", sweep=label, point=point, card=card,
                      same_rows_untraced=same, launches=counts[kernel],
                      kernel_events=held, **got)
                if not held:
                    raise AssertionError(f"the {label} trace of {point} holds "
                                         f"no {name} event: {got['kernels']}")
            if not same:
                raise AssertionError(f"{label}: --profile changed the rows")
        try:
            _sweep(cli, os.path.join(tmp, "refused"),
                   sweeps[0][3] + frames + ["--packed", "--profile", tmp])
        except SystemExit as e:
            if e.code != 2:
                raise
            _emit("refused", sweep="binary --packed --profile", code=e.code)
        else:
            raise AssertionError("--packed --profile was not refused")

        row, counts = counted("minsum_flooding", lambda: profile_phases.measure(
            trace_dir=os.path.join(tmp, "phases")))
        _emit("profile_phases", launches=counts["minsum_flooding"], **row)


def probes(card: str, lib_path) -> dict:
    """Phase 6, the probes K9-K11: every K9/K10 function and K11 chain (at
    two small K) against its plain version on the card, exactly (dot3 and
    trans within their tolerance); the SASS check that no K11 chain was
    folded; the probes' own entry points with their launch counts at 0
    before them (K11's holds its full grid of tile copies against the plain
    chain, then runs its rate table); and each probe's time against its
    plain version and its bound for the kernels line, the timed function's
    output held against the plain one's (K11: every class at
    K11_LINE_STEPS steps)."""
    import torch

    from torch.utils.cpp_extension import CUDA_HOME

    from cuda_ldpc_torch.tools import probe_bitops, probe_mosaic, probe_oprate
    from cuda_ldpc_torch.utils.timing import time_ms
    dev = torch.device("cuda", 0)
    out = {}
    x9 = torch.from_numpy(probe_bitops.tile()).to(dev)
    x10 = torch.from_numpy(probe_mosaic.tile()).to(dev)
    x11 = torch.from_numpy(probe_oprate.tile()).to(dev)

    def extra(fn):
        e = probe_mosaic.extra_input(fn)
        return None if e is None else torch.from_numpy(e).to(dev)

    # parity
    cases = ([("probe_bitops", fn, lambda fn=fn: (
        probe_bitops.compute(fn, x9), probe_bitops.plain(fn, x9)))
              for fn in probe_bitops.FUNCTIONS]
             + [("probe_mosaic", fn, lambda fn=fn: (
                 probe_mosaic.compute(fn, x10, extra(fn)),
                 probe_mosaic.plain(fn, x10, extra(fn))))
                for fn in probe_mosaic.FUNCTIONS]
             + [("probe_oprate", f"{op} n_par {n} K {k}",
                 lambda op=op, n=n, k=k: (
                     probe_oprate.chain(op, x11, n, k),
                     probe_oprate.plain_chain(op, x11, n, k)))
                for op in probe_oprate.OPS for n in probe_oprate.N_PARS
                for k in probe_oprate.CHECK_KS])
    for key, fn, run in cases:
        got, want = run()
        if key == "probe_mosaic":
            bad = probe_mosaic.mismatch(fn, got, want)
        else:
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        err = float((got - want).abs().max())
        e = out.setdefault(key, {"mismatches": 0, "max_abs_err": 0.0})
        e["mismatches"] += bad
        e["max_abs_err"] = max(e["max_abs_err"], err)
        _emit("probe_parity", kernel=key, case=fn, mismatches=bad,
              max_abs_err=err,
              tolerance=probe_mosaic.TOLERANCE.get(fn, 0.0))
        if bad:
            raise AssertionError(f"{key} {fn}: {bad} lanes != plain")

    sass = probe_oprate.sass_unfolded(probe_oprate.sass_counts(
        os.path.join(CUDA_HOME, "bin", "cuobjdump"), str(lib_path)))
    _emit("probe_sass", chains=sass)
    if len(sass) != len(probe_oprate.OPS) * len(probe_oprate.N_PARS) or not \
            all(r["unfolded"] for r in sass):
        raise AssertionError(f"a K11 chain was folded: {sass}")

    # the probes' entry points, counted
    mods = {"probe_bitops": probe_bitops, "probe_mosaic": probe_mosaic,
            "probe_oprate": probe_oprate}
    for key, mod in mods.items():
        mod.LAUNCHES[key] = 0
        rows = mod.run(dev)
        out[key]["launches"] = mod.LAUNCHES[key]
        if out[key]["launches"] <= 0:
            raise AssertionError(f"{key}.run never launched its kernel")
        for row in rows:
            if "ops_per_s_per_sm" in row:
                _emit("oprate", card=card, **row)
            elif row.get("copies", 1) > 1:       # K11's full grid, held
                _emit("probe_parity", kernel=key, **row)

    # time, plain time and bound of one call of each function (K11: every
    # class, n_par 1, K11_LINE_STEPS steps) for the kernels line
    def tile_bytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    fns = {
        "probe_bitops": [
            (fn, lambda fn=fn: probe_bitops.compute(fn, x9),
             lambda fn=fn: probe_bitops.plain(fn, x9), None,
             2 * tile_bytes(x9), 0) for fn in probe_bitops.FUNCTIONS],
        "probe_mosaic": [
            (fn, lambda fn=fn, e=extra(fn): probe_mosaic.compute(fn, x10, e),
             lambda fn=fn, e=extra(fn): probe_mosaic.plain(fn, x10, e),
             {"dot3": lambda: torch.matmul(extra("dot3"),
                                           x10.reshape(16, -1)),
              "roll2": lambda: torch.roll(x10, 37, dims=2)}.get(fn),
             2 * tile_bytes(x10) + tile_bytes(extra(fn)),
             2 * 16 * x10.numel() if fn == "dot3" else 0)
            for fn in probe_mosaic.FUNCTIONS],
        "probe_oprate": [
            (op, lambda op=op: probe_oprate.chain(op, x11, 1, K11_LINE_STEPS),
             lambda op=op: probe_oprate.plain_chain(op, x11, 1,
                                                    K11_LINE_STEPS),
             None, 2 * tile_bytes(x11),
             probe_oprate.FUNCTION_OPS[op] * K11_LINE_STEPS * x11.numel())
            for op in probe_oprate.OPS],
    }
    slower_probes = []
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for key, items in fns.items():
            total = {"ms": 0.0, "plain_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0}
            for fn, kernel, plain, library, nbytes, ops in items:
                extra_fields = {}
                if fn == "roll2":
                    # the one function a single PyTorch call computes at the
                    # same order of time: 11 turns each, alternating, each
                    # time_ms of 20 calls, the medians; the device time of a
                    # call from a fresh process (see roll2_device_times)
                    turns = {"kernel": [], "library": []}
                    for t in range(11):
                        for which in (("kernel", "library") if t % 2 == 0
                                      else ("library", "kernel")):
                            turns[which].append(time_ms(
                                kernel if which == "kernel" else library,
                                dev, 20))
                    ms = statistics.median(turns["kernel"])
                    lms = statistics.median(turns["library"])
                    extra_fields = {"turns": turns, **roll2_device_times()}
                else:
                    ms = time_ms(kernel, dev, 20)
                    lms = time_ms(library, dev, 20) if library else None
                pms = time_ms(plain, dev, 3 if key == "probe_oprate" else 20)
                total["ms"] += ms
                total["plain_ms"] += pms
                total["t_bytes"] += nbytes / HBM_BYTES_PER_S
                total["t_ops"] += ops / FP32_OPS_PER_S
                got, want = kernel(), plain()
                bad = (probe_mosaic.mismatch(fn, got, want)
                       if key == "probe_mosaic" else
                       int((got.view(torch.int32)
                            != want.view(torch.int32)).sum()))
                _emit("probe_timing", kernel=key, fn=fn, card=card, ms=ms,
                      plain_ms=pms, library_ms=lms,
                      bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                                         ops / FP32_OPS_PER_S),
                      mismatches=bad, **extra_fields)
                if fn == "roll2" and ms > lms:
                    slower_probes.append((fn, ms, lms))
                if bad:
                    raise AssertionError(f"{key} {fn} (timed call): {bad} "
                                         "lanes != plain")
            by = "bytes" if total["t_bytes"] > total["t_ops"] else "operations"
            out[key]["timing"] = (
                {"kernel": total["ms"], "plain": total["plain_ms"]},
                1e3 * max(total["t_bytes"], total["t_ops"]), by)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    if slower_probes:
        _emit("probe_slower_than_library", card=card, fn_ms_library_ms=
              slower_probes)
    _emit("probe_bound", card=card, note=(
        "K11's bound is over the whole card's fp32 rate; its tile is 8 "
        f"blocks, on 8 of the card's "
        f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs"))
    return out


def roll2_device_times() -> dict:
    """K10's roll2 and torch.roll's device time a call (torch.profiler,
    over 20 calls) and time_ms a call, from `python -m
    cuda_ldpc_torch.tools.probe_mosaic --timing` in a fresh process: a
    long process's later traces may hold no kernel events (PERF.md
    section 7)."""
    import subprocess
    out = subprocess.run([sys.executable, "-m",
                          "cuda_ldpc_torch.tools.probe_mosaic", "--timing"],
                         check=True, capture_output=True, text=True,
                         timeout=300)
    row = json.loads(out.stdout.strip().splitlines()[-1])
    if row["mismatches"]:
        raise AssertionError(f"roll2 != torch.roll: {row}")
    return {"device_ms": row["device_ms"],
            "library_device_ms": row["library_device_ms"],
            "fresh_process_ms": row["ms"],
            "fresh_process_library_ms": row["library_ms"]}


def encode_parity(dev) -> None:
    """The device encode of a PON_LDPC and a BDS.576.288.GF.64 batch at
    B=4096 (the int8 product, as a card's sweep runs it) and of its first 16
    frames (the float32 product, the rule's choice for B <= 16): the numpy
    encode's codewords on those 16 frames and the next 48, H c = 0 on every
    frame.  Prints each encoder's set-up time (read or eliminated)."""
    import numpy as np
    import torch

    from cuda_ldpc_torch import NBCode, QCBinaryCode
    from cuda_ldpc_torch.models.encoder import BinaryEncoder, NBEncoder
    from cuda_ldpc_torch.ops import minsum, nb_decode

    for name in ("PON_LDPC", "BDS.576.288.GF.64"):
        binary = name == "PON_LDPC"
        code = (QCBinaryCode if binary else NBCode).from_registry(name)
        t0 = time.perf_counter()
        enc = (BinaryEncoder if binary else NBEncoder).from_code(code)
        setup = time.perf_counter() - t0
        width = enc.k_eff * (1 if binary else code.q_bit)
        msg = torch.randint(0, 2, (4096, width), dtype=torch.int8,
                            generator=torch.Generator(device=dev).manual_seed(
                                11), device=dev)
        cw = enc.encode_torch(msg)
        cw16 = enc.encode_torch(msg[:16])
        head = msg[:64].cpu().numpy().astype(np.int64)
        if binary:
            want = enc.encode(head)
            ok = minsum.syndrome_ok(code, cw.reshape(4096, code.L, code.Z))
        else:
            syms = (head.reshape(64, -1, code.q_bit)
                    << np.arange(code.q_bit)).sum(-1)
            want = enc.encode(syms)
            ok = nb_decode._syndrome_ok(nb_decode.build_graph(code), cw)
        counts = {"vs_numpy": int((cw[:64].cpu().numpy() != want).sum()),
                  "first_16_vs_numpy": int(
                      (cw16.cpu().numpy() != want[:16]).sum()),
                  "frames_failing_Hc": int((~ok).sum())}
        _emit("encode_parity", code=name, batch=4096, k_eff=enc.k_eff,
              rank=int(enc.pivots.size), setup_seconds=setup,
              nonzero_share=float((cw != 0).float().mean()),
              mismatches=counts)
        if any(counts.values()):
            raise AssertionError(f"the device encode of {name}: {counts}")


def stream_engine_parity(dev, max_err, mismatches) -> None:
    """K4 as the binary stream engine runs it on random codewords: PON_LDPC,
    Es/N0 2.45 dB, B=4096, calls of 16 passes with refills of channel and
    codeword and the drain, flooding and layered min-sum and flooding bp
    with the syndrome check; the kernel engine against the same engine over
    the plain step, every counter and every state tensor exactly after
    every call."""
    import torch

    from cuda_ldpc_torch import QCBinaryCode, sim
    from cuda_ldpc_torch import config as cfg
    from cuda_ldpc_torch.ops import channel, minsum_stream

    code = QCBinaryCode.from_registry("PON_LDPC")
    B, steps, max_iters = 4096, 16, 50
    sigma_t = torch.tensor([channel.sigma_from_snr(2.45, code.rate, "esn0")],
                           device=dev)
    pid = torch.zeros(B, dtype=torch.int64, device=dev)
    for rule, layered, alpha in (("minsum", False, 1.0),
                                 ("minsum", True, 0.8), ("bp", False, 1.0)):
        dec = cfg.BinaryDecoderConfig(
            rule=rule, schedule="layered" if layered else "flooding",
            check="syndrome", alpha=alpha, max_iters=max_iters,
            kernel="cuda")
        scfg = cfg.BinarySimConfig(code=code.name, decoder=dec,
                                   batch_per_device=B, tx="random",
                                   engine="stream", stream_steps=steps)
        kernel = sim.make_binary_stream_engine(code, scfg, dev)
        plain = sim._kernel_stream(
            functools.partial(minsum_stream.stream_step, code=code,
                              max_iters=max_iters, alpha=alpha, beta=0.0,
                              check="syndrome", rule=rule, layered=layered),
            (code.num_edges, code.Z),
            lambda hard, cw: sim._bit_errors(hard, cw, code.L - code.J),
            sim._binary_source(code, scfg, B, dev), B, 1, max_iters, steps,
            dev)
        ks = kernel.init(torch.Generator(device=dev).manual_seed(950),
                         sigma_t, pid)
        ps = plain.init(torch.Generator(device=dev).manual_seed(950),
                        sigma_t, pid)
        total, per_call = {}, []
        for ci in range(1, 5):
            if ci < 4:
                ks, kc = kernel.run(ks, (17, ci), sigma_t, pid)
                ps, pc = plain.run(ps, (17, ci), sigma_t, pid)
            else:
                ks, kc = kernel.drain(ks)
                ps, pc = plain.drain(ps)
            torch.cuda.synchronize()
            counts = {"counters": int((kc != pc).sum()),
                      **{f"state{j}": int((~same_bits(x, y)).sum())
                         for j, x, y in zip(range(len(ks)), ks, ps)}}
            per_call.append({"call": ci, "counters": kc[0].tolist(),
                             "mismatches": counts})
            for n, c in counts.items():
                total[n] = total.get(n, 0) + c
        label = (f"PON_LDPC esn0 2.45 {'layered' if layered else 'flooding'}"
                 f" {rule} syndrome random codewords")
        mismatches["minsum_stream"] += sum(total.values())
        _emit("parity", kernel="minsum_stream", tx="random", case=label,
              batch=B, calls=per_call, state_tensors=len(ks),
              max_abs_err=float(sum(total.values()) > 0))
        if len(ks) != 7 or any(total.values()):
            raise AssertionError(f"K4's engine != plain on {label}: {total}")
        del kernel, plain, ks, ps
    torch.cuda.empty_cache()


def encode_timing(dev, card) -> None:
    """Phase 5: what a random-codeword batch costs beside its decode, at
    B=4096, in turns (decode, encode, encode, decode), one batch in flight:
    PON_LDPC (the message draw and the product, against K1 flooding min-sum
    with the syndrome check, maxIT 50, early stop, at Es/N0 2.5 dB, as the
    `--tx random` sweep decodes it) and BDS.576.288.GF.64 (against K5
    flooding qspa, maxIT 20, at Eb/N0 2 dB)."""
    import torch

    from cuda_ldpc_torch import NBCode, QCBinaryCode, sim
    from cuda_ldpc_torch import config as cfg
    from cuda_ldpc_torch.models.encoder import BinaryEncoder, NBEncoder
    from cuda_ldpc_torch.ops import channel, cuda_minsum, cuda_qspa

    B = 4096
    for name in ("PON_LDPC", "BDS.576.288.GF.64"):
        binary = name == "PON_LDPC"
        if binary:
            code = QCBinaryCode.from_registry(name)
            enc = BinaryEncoder.from_code(code)
            width, snr = enc.k_eff, 2.5
            scfg = cfg.BinarySimConfig(code=name, batch_per_device=B,
                                       tx="random", decoder=cfg.
                                       BinaryDecoderConfig(check="syndrome"))
            src = sim._binary_source(code, scfg, B, dev)
            sigma = channel.sigma_from_snr(snr, code.rate, "esn0")
        else:
            code = NBCode.from_registry(name)
            enc = NBEncoder.from_code(code)
            width, snr = enc.k_eff * code.q_bit, 2.0
            src = sim._make_nb_source(code, cfg.NBSimConfig(
                code=name, batch_per_device=B, tx="random"), B, dev)
            sigma = channel.sigma_from_snr(snr, code.rate, "ebn0")
        chans = [src(torch.Generator(device=dev).manual_seed(60 + i),
                     sigma)[0] for i in range(2)]

        def launch(which, i):
            if which == "decode":
                if binary:
                    return cuda_minsum.decode_flooding(
                        chans[i % 2], code, 50, check="syndrome")
                return cuda_qspa.decode_flooding(chans[i % 2], code, 20)
            g = torch.Generator(device=dev).manual_seed(70 + i)
            msg = torch.randint(0, 2, (B, width), generator=g,
                                dtype=torch.int8, device=dev)
            return enc.encode_torch(msg)

        runs = time_turns(launch, {"decode": 10, "encode": 20},
                          order=("decode", "encode", "encode", "decode"))
        ms = {k: statistics.median(v) for k, v in runs.items()}
        its = [launch("decode", i).iters for i in range(2)]
        _emit("encode_timing", code=name, batch=B, snr=snr, card=card,
              product_shape=[B, width, int(enc.pivots.size)
                             * (1 if binary else code.q_bit)],
              ms_per_batch=runs, median_ms=ms,
              decode_iters=[float(x.float().mean()) for x in its],
              encode_share_of_decode=ms["encode"] / ms["decode"])


def same_bits(x, y):
    """Elementwise: equal, float32 compared bit for bit (-0.0 != 0.0)."""
    import torch
    if x.dtype == torch.float32:
        return x.view(torch.int32) == y.view(torch.int32)
    return x == y


def _refill(state, new):
    """A stream step's state after a refill: the finished slots take the
    new channel values, their counts and flags reset."""
    import torch
    chan, msgs, t, done, okf = state
    fin = done.bool()
    chan = torch.where(fin.reshape(-1, *([1] * (chan.dim() - 1))), new, chan)
    return [chan, msgs, t * (~fin).int(), torch.zeros_like(done),
            torch.zeros_like(okf)]


def _stream_parity(dev, max_err, mismatches, key, kernel_step, plain_step,
                   chans, msg_shape, max_iters, label, other_step=None):
    """The kernel against the plain step over the stream engines' call
    sequence (k = 1, refill, k = 16, refill, drain k = max_iters + 1), every
    tensor bit for bit; with ``other_step`` (another design of the kernel),
    also the kernel against it, counted under "other_*".  Adds to
    ``max_err`` and ``mismatches`` under ``key``; returns the totals."""
    import torch
    B = chans[0].shape[0]
    z = torch.zeros(B, dtype=torch.int32, device=dev)
    start = [chans[0], torch.zeros((B,) + msg_shape, device=dev), z, z, z]
    ks = [x.clone() for x in start]
    ps = [x.clone() for x in start]
    os_ = [x.clone() for x in start]
    calls = [(1, chans[1]), (16, chans[2]), (max_iters + 1, None)]
    names = ("chan", "msgs", "hard", "t", "done", "okf")
    total, err, per_call = {}, 0.0, []
    for k, new in calls:
        a = kernel_step(*ks, k=k)
        b = plain_step(*ps, k=k)
        o = other_step(*os_, k=k) if other_step else None
        torch.cuda.synchronize()
        okv = b[5].bool()
        counts = {n: int((~same_bits(x, y)).sum())
                  for n, x, y in zip(names, a, b)}
        counts["hard_in_ok_slots"] = int((a[2] != b[2])[okv].sum())
        if o is not None:
            counts.update({f"other_{n}": int((~same_bits(x, y)).sum())
                           for n, x, y in zip(names, a, o)})
        err = max(err, *(float((x.double() - y.double()).abs().max())
                         for x, y in zip(a, b) if x.numel()))
        per_call.append({"k": k, "finished": int(b[4].sum()),
                         "passed": int(okv.sum()), "mismatches": counts})
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        ks = [x for i, x in enumerate(a) if i != 2]
        ps = [x for i, x in enumerate(b) if i != 2]
        if new is not None:
            ks, ps = _refill(ks, new), _refill(ps, new)
        if o is not None:
            os_ = [x for i, x in enumerate(o) if i != 2]
            if new is not None:
                os_ = _refill(os_, new)
    max_err[key] = max(max_err[key], err)
    mismatches[key] += sum(total.values()) - total["hard_in_ok_slots"]
    _emit("parity", kernel=key, case=label, batch=B, calls=per_call,
          max_abs_err=err)
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import numpy as np

    from cuda_ldpc_torch import NBCode, QCBinaryCode, cli, sim
    from cuda_ldpc_torch import config as cfg
    from cuda_ldpc_torch.ops import (_build, channel, cuda_minsum,
                                     cuda_minsum_stream, cuda_nbms, cuda_qspa,
                                     cuda_qspa_qc, cuda_qspa_stream, demod,
                                     minsum, minsum_stream, nb_decode,
                                     onchip, qspa_stream)
    from cuda_ldpc_torch.utils.constellations import constellation
    from cuda_ldpc_torch.utils.device import card_info
    from cuda_ldpc_torch.utils.stats import rates_compatible

    wrappers = (cuda_minsum, cuda_qspa, cuda_qspa_qc, cuda_minsum_stream,
                cuda_qspa_stream, cuda_nbms)

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
    t_phase = time.perf_counter()
    codes = {}

    def code_of(name):
        return codes.setdefault(name, QCBinaryCode.from_registry(name))

    def chan_for(code, snr_type, snr, batch, seed, rule="minsum",
                 tx="zero"):
        """(chan, cw) from the sweep's own source (sim._binary_source): the
        all-zero word (cw None) or random codewords, BPSK + AWGN; bp's true
        LLRs, as the sweep's step gives them."""
        sigma = channel.sigma_from_snr(snr, code.rate, snr_type)
        scfg = cfg.BinarySimConfig(
            code=code.name, batch_per_device=batch, tx=tx,
            decoder=cfg.BinaryDecoderConfig(rule=rule, check="syndrome"))
        return sim._binary_source(code, scfg, batch, dev)(
            torch.Generator(device=dev).manual_seed(seed), sigma)

    def passes_then_fails(batch):
        """Two J4_L24_Z96 frames, tiled to the batch, whose batch needs the
        on-chip stop protocol's lockstep steps (tests/test_torch_cuda_minsum
        .passes_then_fails): a crafted frame that passes the zero check
        early and fails from iteration 3 on, and a noisy one that first
        passes at 7 (layered: 3)."""
        code = code_of("J4_L24_Z96")
        rng = np.random.default_rng(2)
        m = code.L - code.J
        a = np.empty((1, code.L, code.Z), np.float32)
        a[0, :m] = 2.0 * (0.5 + 0.5 * rng.random((m, code.Z)))
        a[0, m:] = -1.0
        noisy = 1.0 + 0.5 * np.random.default_rng(5).standard_normal(
            (16, code.L, code.Z))
        two = torch.from_numpy(np.concatenate([a, noisy[:1].astype(
            np.float32)]))
        return two.repeat((batch + 1) // 2, 1, 1)[:batch].contiguous().to(dev)

    minsum_cases = [
        # code, snr type, snr, batch, iters, check, early stop, alpha, beta
        ("J4_L24_Z96", "ebn0", 3.6, 4096, 50, "zero", True, 1.0, 0.0),
        ("J4_L24_Z96", "ebn0", 3.6, 4096, 50, "syndrome", True, 0.8, 0.1),
        ("J4_L24_Z96", "ebn0", 3.0, 4096, 20, "none", True, 1.0, 0.0),
        ("J4_L24_Z96", "ebn0", 3.6, 37, 50, "syndrome", True, 0.8, 0.1),
        ("J4_L24_Z96", "ebn0", 3.3, 37, 20, "zero", False, 1.0, 0.0),
        ("J4_L24_Z96", "ebn0", 3.6, 11, 50, "syndrome", True, 0.8, 0.1),
        ("J4_L24_Z96", "ebn0", 3.6, 64, 0, "zero", True, 1.0, 0.0),
        ("J4_L24_Z96", "crafted", None, 4096, 20, "zero", True, 1.0, 0.0),
        ("J15_L30_Z1280", "esn0", -1.5, 4096, 50, "zero", True, 1.0, 0.0),
        ("J15_L30_Z1280", "esn0", -1.3, 4096, 50, "syndrome", True, 0.8,
         0.1),
        ("J15_L30_Z1280", "esn0", -1.5, 4096, 10, "none", False, 0.8, 0.1),
        ("PON_LDPC", "esn0", 2.45, 4096, 50, "zero", True, 1.0, 0.0),
        ("PON_LDPC", "esn0", 2.6, 4096, 50, "syndrome", True, 0.8, 0.1),
        ("PON_LDPC", "esn0", 2.45, 4096, 10, "zero", False, 0.8, 0.1),
        ("PON_LDPC", "esn0", 2.45, 4096, 20, "none", True, 1.0, 0.0),
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
    # random codewords (`--tx random`): the rule, then the columns above;
    # last, so that the all-zero cases keep their seeds
    random_cases = [
        ("minsum", "J4_L24_Z96", "ebn0", 3.6, 4096, 50, "syndrome", True, 1.0,
         0.0),
        ("minsum", "J4_L24_Z96", "ebn0", 3.3, 4096, 20, "syndrome", False,
         0.8, 0.1),
        ("minsum", "PON_LDPC", "esn0", 2.5, 4096, 50, "syndrome", True, 1.0,
         0.0),
        ("minsum", "PON_LDPC", "esn0", 2.45, 4096, 10, "syndrome", False, 0.8,
         0.1),
        ("bp", "J4_L24_Z96", "ebn0", 3.6, 4096, 50, "syndrome", True, 1.0,
         0.0),
        ("bp", "PON_LDPC", "esn0", 2.3, 4096, 50, "syndrome", True, 1.0, 0.0),
    ]
    # the bfloat16 storage forms (K1, K2 and K3 with T and R in bf16)
    minsum_bf16_cases = [
        ("J4_L24_Z96", "crafted", None, 4096, 20, "zero", True, 1.0, 0.0),
        ("J4_L24_Z96", "ebn0", 3.6, 4096, 50, "syndrome", True, 0.8, 0.1),
        ("J15_L30_Z1280", "esn0", -1.5, 4096, 50, "zero", True, 1.0, 0.0),
        ("J15_L30_Z1280", "esn0", -1.3, 4096, 50, "syndrome", True, 0.8,
         0.1),
        ("J15_L30_Z1280", "esn0", -1.5, 4096, 10, "none", False, 0.8, 0.1),
        ("PON_LDPC", "esn0", 2.45, 4096, 50, "zero", True, 1.0, 0.0),
        ("PON_LDPC", "esn0", 2.6, 4096, 50, "syndrome", True, 0.8, 0.1),
        ("PON_LDPC", "esn0", 2.45, 4096, 20, "none", True, 1.0, 0.0),
        ("PON_LDPC", "esn0", 2.45, 4096, 10, "zero", False, 0.8, 0.1),
    ]
    bp_bf16_cases = [
        ("J4_L24_Z96", "ebn0", 3.6, 4096, 50, "zero", True, 1.0, 0.0),
        ("J15_L30_Z1280", "esn0", -1.6, 4096, 50, "zero", True, 1.0, 0.0),
        ("J15_L30_Z1280", "esn0", -1.6, 4096, 10, "syndrome", False, 0.8,
         0.1),
        ("PON_LDPC", "esn0", 2.3, 4096, 50, "syndrome", True, 1.0, 0.0),
    ]
    # schedule, rule, tx, msg_dtype, then the columns above; the bf16 cases
    # last, so that the float32 cases keep their seeds
    cases = ([("flooding", "minsum", "zero", None, *c) for c in minsum_cases]
             + [("layered", "minsum", "zero", None, *c)
                for c in minsum_cases]
             + [(s, "bp", "zero", None, *c) for s in ("flooding", "layered")
                for c in bp_cases]
             + [(s, rule, "random", None, *c) for rule, *c in random_cases
                for s in ("flooding", "layered")]
             + [(s, rule, "zero", "bfloat16", *c)
                for rule, table in (("minsum", minsum_bf16_cases),
                                    ("bp", bp_bf16_cases))
                for c in table for s in ("flooding", "layered")])
    max_err = {name: 0.0 for name, _, _ in KERNELS}
    mismatches = {name: 0 for name, _, _ in KERNELS}
    for name in YARDSTICKS.values():
        max_err[name], mismatches[name] = 0.0, 0
    for i, (schedule, rule, tx, dtype, name, st, snr, B, iters, check, early,
            alpha, beta) in enumerate(cases):
        code = code_of(name)
        chan, cw = ((passes_then_fails(B), None) if st == "crafted"
                    else chan_for(code, st, snr, B, seed=100 + i, rule=rule,
                                  tx=tx))
        kw = dict(alpha=alpha, beta=beta, check=check, early_stop=early,
                  rule=rule, msg_dtype=dtype)
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
        key = f"{rule}_{schedule}" + ("_bf16" if dtype else "")
        max_err[key] = max(max_err[key], float(err))
        mismatches[key] += counts["hard"] + counts["ok"]
        wrong = b.hard.bool() if cw is None else b.hard.bool() != cw
        _emit("parity", kernel=key, tx=tx, code=name, snr=f"{st} {snr}",
              batch=B, iters=iters, check=check, early_stop=early,
              alpha=alpha, beta=beta, kernel_iters=int(a.iters),
              plain_iters=int(b.iters), frames_ok=int(a.ok.sum()),
              frames_decoded_to_their_codeword=int(
                  (wrong.flatten(1).sum(1) == 0).sum()),
              mismatches=counts, max_abs_err=err)
        # exact for both rules: the kernel's logf/tanhf and torch.log /
        # torch.tanh on the card agree to the last bit
        if any(v for k, v in counts.items() if k != "hard_in_ok_frames"):
            raise AssertionError(f"kernel != plain on case {i}: {cases[i]}: "
                                 f"{counts}")
        del a, b, chan, cw, hard_diff, wrong
    torch.cuda.empty_cache()

    # GF(q): K5 and K6 against the plain nb_decode on the same CUDA tensors
    nb_codes = {}

    def nb_code(name):
        if name not in nb_codes:
            nb_codes[name] = (synthetic_qc_code(int(name[len("synthetic_gf"):]))
                              if name.startswith("synthetic_gf")
                              else NBCode.from_registry(name))
        return nb_codes[name]

    def nb_chan(code, ebn0, batch, seed, n_qam=2, tx="zero"):
        """(L, tx): symbol LLRs of the all-zero codeword (tx None) or of
        random codewords (the nb sweep's source under `--tx random`,
        sim._make_nb_source), BPSK or QAM + AWGN."""
        sigma = channel.sigma_from_snr(ebn0, code.rate, "ebn0",
                                       float(np.log2(n_qam)))
        g = torch.Generator(device=dev).manual_seed(seed)
        if tx == "random":
            ncfg = cfg.NBSimConfig(code=code.name, batch_per_device=batch,
                                   tx=tx, n_qam=n_qam)
            return sim._make_nb_source(code, ncfg, batch, dev)(g, sigma)
        labels = np.zeros(code.bit_length if n_qam == 2 else code.n_sym,
                          dtype=np.int64)
        return demod.nb_channel_llr(g, labels, constellation(n_qam), sigma,
                                    batch, code.q, device=dev), None

    nb_pairs = {   # kernel name -> (wrapper, plain version)
        "qspa_flooding": (cuda_qspa.decode_flooding, nb_decode.decode_qspa),
        "qspa_layered": (cuda_qspa.decode_layered,
                         nb_decode.decode_layered_qspa),
        "qspa_glayered": (cuda_qspa.decode_glayered,
                          nb_decode.decode_glayered_qspa),
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
        ("Tanner_74_9_Z128_GF16", 3.3, 2, 256, 20, False),
        ("Tanner_74_9_Z128_GF16", 4.3, 2, 256, 20, True),
        ("Tanner_74_9_Z128_GF16", 3.4, 2, 11, 20, False),
        ("synthetic_gf4", 2.5, 2, 37, 12, True),
        ("synthetic_gf16", 2.5, 2, 37, 12, True),
        ("synthetic_gf32", 3.0, 2, 37, 12, True),
    ]
    # random codewords: the kernel, then the columns above; last, so that
    # the all-zero cases keep their seeds
    nb_random = [
        ("qspa", "BDS.576.288.GF.64", 1.5, 2, 4096, 20, True),
        ("qspa", "BDS.576.288.GF.64", 7.0, 64, 4096, 20, True),
        ("qspa_qc", "Tanner_74_9_Z128_GF16", 3.3, 2, 256, 20, True),
    ]
    # the grouped-layered K5 last, so that the cases above keep their seeds
    nb_cases = ([(f"qspa_{s}", "zero", *c) for s in ("flooding", "layered")
                 for c in k5_cases]
                + [(f"qspa_qc_{s}", "zero", *c)
                   for s in ("flooding", "layered") for c in k6_cases]
                + [(f"{k}_{s}", "random", *c) for k, *c in nb_random
                   for s in ("flooding", "layered")]
                + [("qspa_glayered", "zero", *c) for c in k5_cases]
                + [("qspa_glayered", "random", *c) for k, *c in nb_random
                   if k == "qspa"])
    for i, (key, tx, name, ebn0, n_qam, B, iters,
            early) in enumerate(nb_cases):
        code = nb_code(name)
        L, sent = nb_chan(code, ebn0, B, seed=300 + i, n_qam=n_qam, tx=tx)
        kernel, plain = nb_pairs[key]
        a = kernel(L, code, iters, early_stop=early)
        b = plain(L, code, iters, early_stop=early)
        # K6: the staged kernel against the global design too; K5, where
        # the rule picks a row on one warp: against a warp an edge; every
        # output of every frame
        if key.startswith("qspa_qc"):
            others = {"global": getattr(
                cuda_qspa_qc, f"decode_{key[len('qspa_qc_'):]}_global")(
                    L, code, iters, early_stop=early)}
        else:
            layout = cuda_qspa.row_layout(cuda_qspa.make_plan(code))
            others = ({"groups": cuda_qspa.decode_design(
                L, code, iters, key[len("qspa_"):], "groups",
                early_stop=early)} if layout == "warp" else {})
        torch.cuda.synchronize()
        hard_diff = a.hard != b.hard
        counts = {"hard": int(hard_diff.sum()),
                  "hard_in_ok_frames": int(hard_diff[b.ok].sum()),
                  "ok": int((a.ok != b.ok).sum()),
                  "iters": int((a.iters != b.iters).sum())}
        for d, g in others.items():
            counts.update({f"{d}_hard": int((a.hard != g.hard).sum()),
                           f"{d}_ok": int((a.ok != g.ok).sum()),
                           f"{d}_iters": int((a.iters != g.iters).sum())})
        # the largest |kernel - plain| over hard symbols, ok and iters
        err = max([int((a.hard - b.hard).abs().max()) if B else 0,
                   counts["ok"] > 0,
                   int((a.iters - b.iters).abs().max()) if B else 0])
        max_err[key] = max(max_err[key], float(err))
        mismatches[key] += sum(v for k, v in counts.items()
                               if k != "hard_in_ok_frames")
        _emit("parity", kernel=key, tx=tx, code=name, ebn0=ebn0,
              n_qam=n_qam, batch=B, iters=iters, early_stop=early,
              layout=None if key.startswith("qspa_qc") else layout,
              frames_ok=int(b.ok.sum()),
              frames_decoded_to_their_codeword=int((b.hard == (
                  0 if sent is None else sent)).all(1).sum()),
              avg_iters=float(b.iters.float().mean()) if B else 0.0,
              mismatches=counts, max_abs_err=err)
        # K5 exactly on every frame; K6's hard on frames whose check passed
        if any(v for k, v in counts.items()
               if k != "hard" or not key.startswith("qspa_qc")):
            raise AssertionError(f"kernel != plain or another design on "
                                 f"GF(q) case {i}: {nb_cases[i]}: {counts}")
        del a, b, others, L, sent, hard_diff
    torch.cuda.empty_cache()

    # K6's block-row schedule on Tanner_74_9_Z128_GF16, whose row groups
    # are its block rows in row order, is the serial-row layered QSPA:
    # against the plain decode_layered_qspa (1152 rows a pass, one at a
    # time: ~3 s a pass whatever the batch), K6's rule, at a point where
    # some frames pass within the 6 passes and some do not
    tanner_code = nb_code("Tanner_74_9_Z128_GF16")
    if not cuda_qspa_qc.layered_is_block_rows(tanner_code):
        raise AssertionError("Tanner's row groups are not its block rows")
    key = "qspa_qc_layered"
    for i, (ebn0, B, iters, early) in enumerate([(3.5, 256, 6, True)]):
        L, _ = nb_chan(tanner_code, ebn0, B, seed=390 + i)
        a = cuda_qspa_qc.decode_layered(L, tanner_code, iters,
                                        early_stop=early)
        b = nb_decode.decode_layered_qspa(L, tanner_code, iters,
                                          early_stop=early)
        torch.cuda.synchronize()
        hard_diff = a.hard != b.hard
        counts = {"hard": int(hard_diff.sum()),
                  "hard_in_ok_frames": int(hard_diff[b.ok].sum()),
                  "ok": int((a.ok != b.ok).sum()),
                  "iters": int((a.iters != b.iters).sum())}
        err = max(int((a.hard - b.hard).abs().max()), counts["ok"] > 0,
                  int((a.iters - b.iters).abs().max()))
        max_err[key] = max(max_err[key], float(err))
        mismatches[key] += sum(v for k, v in counts.items() if k != "hard")
        _emit("parity", kernel=key, plain="decode_layered_qspa", tx="zero",
              code=tanner_code.name, ebn0=ebn0, batch=B, iters=iters,
              early_stop=early, frames_ok=int(b.ok.sum()),
              avg_iters=float(b.iters.float().mean()), mismatches=counts,
              max_abs_err=err)
        if counts["hard_in_ok_frames"] or counts["ok"] or counts["iters"]:
            raise AssertionError(f"K6 != the plain serial-row layered QSPA "
                                 f"on Tanner at {ebn0} dB, B={B}: {counts}")
        del a, b, L, hard_diff
    torch.cuda.empty_cache()

    # K8 against the plain nb_decode: every output exactly equal
    k8_pairs = {
        "nbms_ems": (cuda_nbms.decode_ems, nb_decode.decode_ems),
        "nbms_tmm": (cuda_nbms.decode_tmm, nb_decode.decode_tmm),
        "nbms_layered_tmm": (cuda_nbms.decode_layered_tmm,
                             nb_decode.decode_layered_tmm),
        "nbms_ems_full": (cuda_nbms.decode_ems_full,
                          functools.partial(nb_decode.decode_ems, full=True)),
        "nbms_glayered_tmm": (
            cuda_nbms.decode_glayered_tmm,
            lambda L, code, iters: nb_decode.decode(L, code, "glayered_tmm",
                                                    iters)),
    }
    k8_cases = [
        # code, Eb/N0, batch, iterations, and the passes of the case that
        # the plain layered TMM (about 0.6 s a pass whatever the batch)
        # runs, None where it does not join: one case a code at 8 passes,
        # but BDS's ragged batch at 20, where frames converge late, and
        # the batches of 0 and 1 pass
        ("BDS.576.288.GF.64", 3.0, 4096, 20, None),   # most frames converge
        ("BDS.576.288.GF.64", 0.5, 1024, 20, None),   # few do
        ("BDS.576.288.GF.64", 1.0, 4096, 1, 1),
        ("BDS.576.288.GF.64", 2.0, 37, 20, 20),
        ("BDS.576.288.GF.64", 2.0, 64, 0, 0),
        ("BDS.576.288.GF.64", 0.0, 512, 20, None),
        ("BDS.576.288.GF.64", 2.0, 512, 20, None),
        ("BDS.576.288.GF.64", 4.0, 512, 20, None),
        ("LDPC_N576_K288_GF64_d1_exp", 3.0, 4096, 20, 8),
        ("LDPC_N576_K288_GF64_d1_exp", 1.0, 512, 20, None),
        # GF(256): the plain TMM's search over q^2 candidates a row is slow
        ("LDPC_N96_K48_GF256_d1_exp", 2.0, 64, 20, 8),
        ("LDPC_N576_K480_GF256_exp", 3.0, 16, 20, 8),
    ]
    k8_random = [   # random codewords, last (the cases above keep seeds)
        ("BDS.576.288.GF.64", 3.0, 4096, 20, None),
        ("BDS.576.288.GF.64", 2.5, 1024, 10, 8),
    ]
    k8_all = ([(*c, "zero") for c in k8_cases]
              + [(*c, "random") for c in k8_random])
    for key in k8_pairs:
        for i, (name, ebn0, B, iters, layered_iters,
                tx) in enumerate(k8_all):
            if key == "nbms_layered_tmm":
                if layered_iters is None:
                    continue
                iters = layered_iters
            code = nb_code(name)
            if key == "nbms_ems_full":
                # the plain full EMS holds [B, M, q, q] a convolution
                B = min(B, 1024 if code.q <= 64 else 64)
            L, sent = nb_chan(code, ebn0, B, seed=800 + i, tx=tx)
            kernel, plain = k8_pairs[key]
            b = plain(L, code, iters)
            runs = [(key, kernel)]
            if key == "nbms_ems_full":
                runs.append((YARDSTICKS[key], cuda_nbms.decode_ems_full_dense))
            for name_, kernel_ in runs:
                a = kernel_(L, code, iters)
                torch.cuda.synchronize()
                counts = {"hard": int((a.hard != b.hard).sum()),
                          "ok": int((a.ok != b.ok).sum()),
                          "iters": int((a.iters != b.iters).sum())}
                err = max([int((a.hard - b.hard).abs().max()) if B else 0,
                           counts["ok"] > 0,
                           int((a.iters - b.iters).abs().max()) if B else 0])
                max_err[name_] = max(max_err[name_], float(err))
                mismatches[name_] += sum(counts.values())
                _emit("parity", kernel=name_, tx=tx, code=name, ebn0=ebn0,
                      batch=B, iters=iters, groups=cuda_nbms.groups(
                          cuda_nbms.make_plan(code), name_[len("nbms_"):]),
                      frames_ok=int(b.ok.sum()),
                      frames_decoded_to_their_codeword=int((b.hard == (
                          0 if sent is None else sent)).all(1).sum()),
                      avg_iters=float(b.iters.float().mean()),
                      mismatches=counts, max_abs_err=err)
                if any(counts.values()):
                    raise AssertionError(f"K8 != plain on {name_} "
                                         f"{k8_all[i]}: {counts}")
                del a
            del b, L, sent
        torch.cuda.empty_cache()

    # K8's mode ems_nmnc against the plain EMS at the same Nm/Nc, every
    # branch: conf(q,1) alone (Nm = 1, Nc = 1), the pairs (Nc = 2), the
    # chains (Nc >= dc - 1: BDS and the dc = 4 codes at Nc = 3), the
    # budgeted chains (LDPC_N576_K480_GF256_exp, dc = 12, Nc = 3 to 10);
    # the plain pairs cost ~(Nm - 1)^2 dc (dc - 1) / 2 * 6 launches a pass
    # (~2-3 s a pass at Nm = 64), hence Nm = 64's 3 passes
    nmnc_cases = [
        # code, Nm, Nc, Eb/N0, batch, iterations, tx
        ("BDS.576.288.GF.64", 1, 2, 1.5, 512, 20, "zero"),
        ("BDS.576.288.GF.64", 3, 1, 1.5, 512, 20, "zero"),
        ("BDS.576.288.GF.64", 3, 2, 1.5, 512, 20, "random"),
        ("BDS.576.288.GF.64", 16, 2, 1.5, 256, 20, "zero"),
        ("BDS.576.288.GF.64", 16, 2, 2.0, 37, 20, "zero"),
        ("BDS.576.288.GF.64", 64, 2, 2.5, 64, 3, "zero"),
        ("BDS.576.288.GF.64", 8, 3, 1.0, 1024, 20, "zero"),
        ("BDS.576.288.GF.64", 64, 3, 1.5, 1024, 20, "zero"),
        ("BDS.576.288.GF.64", 64, 3, 2.0, 1024, 20, "random"),
        ("BDS.576.288.GF.64", 64, 3, 1.0, 4096, 1, "zero"),
        ("BDS.576.288.GF.64", 64, 3, 1.0, 64, 0, "zero"),
        ("LDPC_N576_K288_GF64_d1_exp", 4, 2, 2.0, 512, 20, "zero"),
        ("LDPC_N576_K288_GF64_d1_exp", 64, 3, 2.0, 512, 20, "zero"),
        ("LDPC_N96_K48_GF256_d1_exp", 8, 2, 2.0, 64, 20, "zero"),
        ("LDPC_N96_K48_GF256_d1_exp", 256, 3, 2.0, 64, 20, "zero"),
        ("LDPC_N576_K480_GF256_exp", 3, 3, 3.0, 16, 20, "zero"),
        ("LDPC_N576_K480_GF256_exp", 4, 5, 3.0, 16, 20, "zero"),
        ("LDPC_N576_K480_GF256_exp", 8, 10, 3.0, 16, 20, "zero"),
        ("LDPC_N576_K480_GF256_exp", 8, 10, 3.0, 23, 10, "zero"),
        # the most budget levels (Nc = 6), listed and dense messages; the
        # unbudgeted chains at dc = 12
        ("LDPC_N576_K480_GF256_exp", 8, 6, 3.0, 16, 20, "zero"),
        ("LDPC_N576_K480_GF256_exp", 100, 6, 3.0, 16, 20, "zero"),
        ("LDPC_N576_K480_GF256_exp", 8, 11, 3.0, 16, 20, "zero"),
    ]
    key = "nbms_ems_nmnc"
    for i, (name, nm, nc, ebn0, B, iters, tx) in enumerate(nmnc_cases):
        code = nb_code(name)
        L, sent = nb_chan(code, ebn0, B, seed=900 + i, tx=tx)
        t0 = time.perf_counter()
        b = nb_decode.decode_ems(L, code, iters, nm=nm, nc=nc)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for name_, kernel_ in (
                (key, cuda_nbms.decode_ems),
                (YARDSTICKS[key], cuda_nbms.decode_ems_nmnc_dense)):
            t0 = time.perf_counter()
            a = kernel_(L, code, iters, nm=nm, nc=nc)
            torch.cuda.synchronize()
            kernel_s = time.perf_counter() - t0
            counts = {"hard": int((a.hard != b.hard).sum()),
                      "ok": int((a.ok != b.ok).sum()),
                      "iters": int((a.iters != b.iters).sum())}
            err = max([int((a.hard - b.hard).abs().max()), counts["ok"] > 0,
                       int((a.iters - b.iters).abs().max())])
            max_err[name_] = max(max_err[name_], float(err))
            mismatches[name_] += sum(counts.values())
            _emit("parity", kernel=name_, tx=tx, code=name, nm=nm, nc=nc,
                  branch=cuda_nbms.ems_branch(nm, nc, code.max_dc),
                  ebn0=ebn0, batch=B, iters=iters, groups=cuda_nbms.groups(
                      cuda_nbms.make_plan(code), name_[len("nbms_"):], nm,
                      nc),
                  frames_ok=int(b.ok.sum()),
                  frames_decoded_to_their_codeword=int((b.hard == (
                      0 if sent is None else sent)).all(1).sum()),
                  avg_iters=float(b.iters.float().mean()),
                  kernel_s=kernel_s, plain_s=plain_s, mismatches=counts,
                  max_abs_err=err)
            if any(counts.values()):
                raise AssertionError(f"K8 != plain on {name_} "
                                     f"{nmnc_cases[i]}: {counts}")
            del a
        del b, L, sent
    torch.cuda.empty_cache()

    # K4 and K7 against their plain versions over the stream engines' call
    # sequence: k = 1, refill, k = 16, refill, drain (k = max_iters + 1);
    # both on the card, each on its own copy of the state
    stream_parity = functools.partial(_stream_parity, dev, max_err,
                                      mismatches)

    k4_cases = [
        # code, snr type, snr, batch, max_iters
        ("J4_L24_Z96", "ebn0", 3.6, 4096, 50),
        ("J4_L24_Z96", "ebn0", 3.3, 37, 20),
        ("PON_LDPC", "esn0", 2.45, 4096, 50),
        ("J15_L30_Z1280", "esn0", -1.5, 4096, 50),
    ]
    # (check, alpha, beta) of each sequence: zero with the main path's
    # alpha (0.8 for layered min-sum), then syndrome and, for min-sum, zero
    # with alpha 0.8 and beta 0.1 (outputs of 0.0 and -0.0)
    k4_params = {"minsum": [("zero", None, 0.0), ("syndrome", 0.8, 0.1),
                            ("zero", 0.8, 0.1)],
                 "bp": [("zero", 1.0, 0.0), ("syndrome", 0.8, 0.1)]}
    for i, (name, st, snr, B, max_iters) in enumerate(k4_cases):
        code = code_of(name)
        for layered in (False, True):
            for rule in ("minsum", "bp"):
                chans = [chan_for(code, st, snr, B, seed=500 + 7 * i + j,
                                  rule=rule)[0] for j in range(3)]
                for check, alpha, beta in k4_params[rule]:
                    if alpha is None:
                        alpha = 0.8 if layered else 1.0
                    kw = dict(code=code, max_iters=max_iters, check=check,
                              rule=rule, layered=layered, alpha=alpha,
                              beta=beta)
                    label = (f"{name} {st} {snr} "
                             f"{'layered' if layered else 'flooding'} {rule} "
                             f"{check} alpha {alpha} beta {beta}")
                    other = (functools.partial(
                        cuda_minsum_stream.global_stream_step, **kw)
                        if rule == "minsum" else None)
                    total = stream_parity(
                        "minsum_stream",
                        functools.partial(cuda_minsum_stream.stream_step,
                                          **kw),
                        functools.partial(minsum_stream.stream_step, **kw),
                        chans, (code.num_edges, code.Z), max_iters, label,
                        other_step=other)
                    # exact, as K1-K3: every output and state tensor, and
                    # min-sum's on-chip state bit for bit the global design's
                    if any(total.values()):
                        raise AssertionError(f"K4 != plain or the global "
                                             f"design on {label}: {total}")
                del chans
        torch.cuda.empty_cache()

    k7_cases = [
        # code, Eb/N0, batch
        ("BDS.576.288.GF.64", 1.0, 4096),
        ("BDS.576.288.GF.64", 1.5, 37),
        ("BDS.576.288.GF.64", 0.0, 512),
        ("BDS.576.288.GF.64", 2.0, 512),
        ("BDS.576.288.GF.64", 4.0, 512),
        ("LDPC_N576_K288_GF64_d1_exp", 2.0, 512),
        ("LDPC_N96_K48_GF256_d1_exp", 2.0, 1024),
        ("LDPC_N576_K480_GF256_exp", 3.0, 512),
    ]
    k7_random = [("BDS.576.288.GF.64", 1.0, 4096)]   # last: seeds above kept
    for i, (name, ebn0, B, tx) in enumerate(
            [(*c, "zero") for c in k7_cases]
            + [(*c, "random") for c in k7_random]):
        code = nb_code(name)
        chans = [nb_chan(code, ebn0, B, seed=700 + 5 * i + j, tx=tx)[0]
                 for j in range(3)]
        E = int(code.cn_mask.sum())
        for layered in (False, True, "glayered"):
            kw = dict(code=code, max_iters=20, layered=layered)
            label = (f"{name} {ebn0} {qspa_stream.schedule(layered)}"
                     + (" random codewords" if tx == "random" else ""))
            total = stream_parity(
                "qspa_stream_glayered" if layered == "glayered"
                else "qspa_stream",
                functools.partial(cuda_qspa_stream.stream_step, **kw),
                functools.partial(qspa_stream.stream_step, **kw),
                chans, (E, code.q), 20, label)
            # as K5: every output and state tensor bit for bit
            if any(total.values()):
                raise AssertionError(f"K7 != plain on {label}: {total}")
        del chans
    torch.cuda.empty_cache()

    # K4 as the stream engine runs it on random codewords, and the device
    # encode
    stream_engine_parity(dev, max_err, mismatches)
    encode_parity(dev)

    _emit("phase_seconds", name="parity",
          seconds=time.perf_counter() - t_phase)

    # ---- 4. the main path, through the CLI
    t_phase = time.perf_counter()
    keep = ("snr", "frames", "error_frames", "error_units", "fer", "ber",
            "avg_iters", "false_frames", "alarm_frames", "info_mbps")
    launches = {}

    def drive(tmp, label, kernel, argv, also=(), never=(), no_plain=False):
        """One sweep with every launch count at 0 before it; the counts
        are read after it, and the named kernel (and each count named in
        ``also``) must have launched, and none named in ``never``; with
        ``no_plain``, no plain GF(q) decoder core (nb_decode.build_core,
        which the plain decode, the plain stream step and the plain stream
        engine build) may have been built."""
        for w in wrappers:
            for k in w.LAUNCHES:
                w.LAUNCHES[k] = 0
        plain_calls = []
        plain = nb_decode.build_core
        if no_plain:
            nb_decode.build_core = lambda *a, **kw: (plain_calls.append(1),
                                                     plain(*a, **kw))[1]
        t0 = time.perf_counter()
        try:
            rows = _sweep(cli, os.path.join(tmp, label), argv)
        finally:
            nb_decode.build_core = plain
        seconds = time.perf_counter() - t0
        counts = {k: v for w in wrappers for k, v in w.LAUNCHES.items()}
        if no_plain:
            counts["plain_nb_core"] = len(plain_calls)
            if plain_calls:
                raise AssertionError(f"the {label} sweep ran the plain "
                                     f"decoder {len(plain_calls)} times")
        for k in (*([kernel] if kernel else []), *also):
            if counts[k] <= 0:
                raise AssertionError(f"the {label} sweep never launched the "
                                     f"{k} kernel: {counts}")
        if any(counts[k] for k in never):
            raise AssertionError(f"the {label} sweep launched one of "
                                 f"{never}: {counts}")
        _emit("main_path", sweep=label, seconds=seconds, launches=counts,
              rows=[{k: r[k] for k in keep} for r in rows])
        if not all(r["frames"] > 0 and 0.0 <= r["fer"] <= 1.0 for r in rows):
            raise AssertionError(f"bad {label} rows: {rows}")
        return rows, counts[kernel] if kernel else 0

    def same_rows(label, got, want):
        """Two sweeps' rows, counter for counter."""
        counters = ("snr", "frames", "error_frames", "error_units",
                    "iter_sum")
        a = [{k: r[k] for k in counters} for r in got]
        b = [{k: r[k] for k in counters} for r in want]
        _emit("same_rows", sweep=label, same=a == b, rows=a, other=b)
        if a != b:
            raise AssertionError(f"{label}: the rows differ")

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

    def same_fer(label, got, batch_rows):
        """Each point's FER against another sweep's at the same points
        (the batch engine's, or float32's), Clopper-Pearson."""
        pairs = [(a["snr"], a["error_frames"], a["frames"],
                  b["error_frames"], b["frames"],
                  rates_compatible(a["error_frames"], a["frames"],
                                   b["error_frames"], b["frames"]))
                 for a, b in zip(got, batch_rows)]
        _emit("fer_vs_batch", sweep=label,
              snr_errors_frames_batch_errors_frames_compatible=pairs)
        if len(got) != len(batch_rows) or not all(p[-1] for p in pairs):
            raise AssertionError(f"{label}: FER not compatible with the "
                                 f"batch engine's: {pairs}")

    j15 = ["binary", "--code", "J15_L30_Z1280", "--snr=-1.6:0.1:-1.4",
           "--snr-type", "esn0", "--max-iters", "50", "--batch", "4096",
           "--least-error-frames", "50", "--least-test-frames", "4096",
           "--max-frames", "12288"]
    pon = ["binary", "--code", "PON_LDPC", "--snr", "2.4:0.2:2.6",
           "--snr-type", "esn0", "--max-iters", "50", "--batch", "4096",
           "--least-error-frames", "50", "--least-test-frames", "4096",
           "--max-frames", "12288"]
    # (the waterfall of the JAX package's own decoder lies at 3.2-3.6 dB;
    # VALIDATION.md:34's FER 0.81 at 4.2 dB is not what nb_decode gives)
    tanner = ["nb", "--code", "Tanner_74_9_Z128_GF16", "--snr", "3.2:0.2:3.6",
              "--snr-type", "ebn0", "--max-iters", "20", "--batch", "256",
              "--least-error-frames", "50", "--least-test-frames", "512",
              "--max-frames", "1024"]
    with tempfile.TemporaryDirectory() as tmp:
        rows, launches["minsum_flooding"] = drive(tmp, "j15", "minsum_flooding",
                                                  j15)
        j15_batch = rows
        if len(rows) != 3 or not all(r["frames"] >= 4096 for r in rows):
            raise AssertionError(f"bad J15_L30_Z1280 rows: {rows}")
        if not rows[0]["fer"] >= rows[-1]["fer"]:
            raise AssertionError("FER does not fall across the waterfall")
        lay, launches["minsum_layered"] = drive(
            tmp, "j15_layered", "minsum_layered", j15 + ["--schedule",
                                                         "layered"])
        j15_layered = lay
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
        j15_bp_batch = bp
        bp_lay, launches["bp_layered"] = drive(
            tmp, "j15_bp_layered", "bp_layered",
            j15 + ["--rule", "bp", "--schedule", "layered"])
        no_slower("j15 bp", bp_lay, bp)

        # the same sweeps with T and R stored in bfloat16: the bf16 kernels
        # launch and no float32 one; FER compatible with float32's
        bf16 = ["--msg-dtype", "bfloat16"]
        for label, kernel, extra, f32_rows in [
                ("j15_bf16", "minsum_flooding", [], j15_batch),
                ("j15_layered_bf16", "minsum_layered",
                 ["--schedule", "layered"], j15_layered),
                ("j15_bp_bf16", "bp_flooding", ["--rule", "bp"], bp),
                ("j15_bp_layered_bf16", "bp_layered",
                 ["--rule", "bp", "--schedule", "layered"], bp_lay),
                ("j15_packed_bf16", "minsum_flooding", ["--packed"],
                 j15_batch)]:
            got, n = drive(tmp, label, f"{kernel}_bf16", j15 + bf16 + extra,
                           never=(kernel,))
            launches[f"{kernel}_bf16"] = launches.get(f"{kernel}_bf16",
                                                      0) + n
            same_fer(label, got, f32_rows)
        try:
            _sweep(cli, os.path.join(tmp, "refused_bf16_stream"),
                   j15 + bf16 + ["--engine", "stream"])
        except SystemExit as e:
            if e.code != 2:
                raise
            _emit("refused", sweep="j15 --engine stream --msg-dtype "
                  "bfloat16", code=e.code)
        else:
            raise AssertionError("the stream engine ran --msg-dtype "
                                 "bfloat16")

        rows, _ = drive(tmp, "pon", "minsum_flooding", pon)
        pon_zero = rows
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

        # GF(q): BDS.576.288.GF.64 at 1 dB against VALIDATION.md:21-22; K5
        # runs a row on one warp there
        bds_plan = cuda_qspa.make_plan(nb_code("BDS.576.288.GF.64"))
        _emit("k5_layout", code="BDS.576.288.GF.64",
              layout=cuda_qspa.row_layout(bds_plan),
              shape={s: cuda_qspa.launch_shape(bds_plan, s == "layered",
                                               "warp")
                     for s in ("flooding", "layered")})
        if cuda_qspa.row_layout(bds_plan) != "warp":
            raise AssertionError("K5 does not put BDS's rows on one warp")
        # at Eb/N0 1 and 2 dB (VALIDATION.md:21-22: qspa 598/2304 and
        # 3.245e-3 of 16640 frames, layered 872/4096 and 1.311e-3 of 38912)
        bds_k5 = ["nb", "--code", "BDS.576.288.GF.64", "--snr", "1:1:2",
                  "--snr-type", "ebn0", "--max-iters", "20", "--batch",
                  "4096", "--least-error-frames", "50",
                  "--least-test-frames", "8192", "--max-frames", "16384"]
        # K5's counts by design show the row on one warp ran, both schedules
        flood, launches["qspa_flooding"] = drive(
            tmp, "bds_qspa", "qspa_flooding", bds_k5 + ["--method", "qspa"],
            also=("qspa_warp_flooding",))
        bds_batch = {"qspa": flood[:1]}
        anchor("bds_qspa", "BDS.576.288.GF.64", 1.0, flood[0], (598, 2304))
        anchor("bds_qspa", "BDS.576.288.GF.64", 2.0, flood[1], (54, 16640))
        lay, launches["qspa_layered"] = drive(
            tmp, "bds_layered_qspa", "qspa_layered",
            bds_k5 + ["--method", "layered_qspa"],
            also=("qspa_warp_layered",))
        anchor("bds_layered_qspa", "BDS.576.288.GF.64", 1.0, lay[0],
               (872, 4096))
        anchor("bds_layered_qspa", "BDS.576.288.GF.64", 2.0, lay[1],
               (51, 38912))
        bds_batch["layered_qspa"] = lay[:1]
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
        # layered_qspa on Tanner is K6's block-row schedule (its row groups
        # are its block rows in row order): the same launch on the same
        # noise as glayered_qspa, so the same rows
        serial, n = drive(tmp, "tanner_layered_qspa", "qspa_qc_layered",
                          tanner + ["--method", "layered_qspa"],
                          no_plain=True)
        launches["qspa_qc_layered"] += n
        same_rows("tanner layered_qspa vs glayered_qspa", serial, lay)

        # the grouped-layered schedule on BDS (VALIDATION.md has no row for
        # it): K8 and K5 against the same sweep under --kernel torch, the
        # same seed, row for row; 2048 frames a point (the batch that meets
        # the 1024-frame cap and the one in flight)
        bds2k = (bds_k5[:bds_k5.index("--batch")]
                 + ["--batch", "1024", "--least-error-frames", "50",
                    "--least-test-frames", "1024", "--max-frames", "1024"])
        for method, kernel in (("glayered_tmm", "nbms_glayered_tmm"),
                               ("glayered_qspa", "qspa_glayered")):
            got, launches[kernel] = drive(
                tmp, f"bds_{method}", kernel, bds2k + ["--method", method],
                no_plain=True)
            want, _ = drive(tmp, f"bds_{method}_torch", None,
                            bds2k + ["--method", method, "--kernel",
                                     "torch"])
            same_rows(f"bds {method} vs --kernel torch", got, want)
            bds_batch[method] = got[:1]

        # ---- the stream and packed engines: K4 and K7 on the main path
        launches["minsum_stream"] = launches["qspa_stream"] = 0
        engine_rows = []

        stream = ["--engine", "stream"]
        for label, kernel, extra, batch_rows in [
                ("j15_stream", "minsum_stream_flooding", [], j15_batch),
                ("j15_stream_layered_a08", "minsum_stream_layered",
                 norm + ["--schedule", "layered"], lay08),
                ("j15_stream_bp", "bp_stream_flooding", ["--rule", "bp"],
                 j15_bp_batch)]:
            got, n = drive(tmp, label, kernel, j15 + stream + extra)
            launches["minsum_stream"] += n
            same_fer(label, got, batch_rows)
            engine_rows.append((label, got, batch_rows))

        # the reference's committed workload as one packed sweep
        pon_grid = ["binary", "--code", "PON_LDPC", "--packed", "--snr",
                    "0:0.2:13", "--snr-type", "esn0", "--max-iters", "50",
                    "--batch", "4096", "--least-error-frames", "50",
                    "--least-test-frames", "10000", "--max-frames", "20000"]
        t0 = time.perf_counter()
        grid, _ = drive(tmp, "pon_packed", "minsum_flooding", pon_grid)
        grid_s = time.perf_counter() - t0
        frames = sum(r["frames"] for r in grid)
        _emit("pon_packed", points=len(grid), frames=frames, seconds=grid_s,
              info_mbps=frames * code_of("PON_LDPC").k / grid_s / 1e6,
              card=card)
        if len(grid) != 66:
            raise AssertionError(f"PON_LDPC grid has {len(grid)} points")
        # VALIDATION.md:173-174: 0.233 at 2.4 dB (its frame count is not
        # given; taken as the stop rule's 10,000), 6.03e-4 at 2.6 dB (50
        # errors, so 82,919 frames), 0 errors in 200k frames from 2.8 dB
        for r in grid:
            if abs(r["snr"] - 2.4) < 1e-6:
                anchor("pon_packed", "PON_LDPC", 2.4, r, (2330, 10000))
            elif abs(r["snr"] - 2.6) < 1e-6:
                anchor("pon_packed", "PON_LDPC", 2.6, r, (50, 82919))
            elif r["snr"] > 2.7:
                anchor("pon_packed", "PON_LDPC", r["snr"], r, (0, 200000))

        got, n = drive(tmp, "j15_packed_stream", "minsum_stream_flooding",
                       j15 + stream + ["--packed"])
        launches["minsum_stream"] += n
        same_fer("j15_packed_stream", got, j15_batch)
        engine_rows.append(("j15_packed_stream", got, j15_batch))

        bds12 = ["nb", "--code", "BDS.576.288.GF.64", "--snr", "1:1:2",
                 "--snr-type", "ebn0", "--max-iters", "20", "--batch", "4096",
                 "--least-error-frames", "50", "--least-test-frames", "8192",
                 "--max-frames", "8192"]
        # qspa and layered_qspa against VALIDATION.md:21-22 at 1 dB;
        # grouped-layered (no VALIDATION.md row, and the kernel engine's
        # per-call refill draws other noise than the plain engine's) against
        # the batch engine's rows, which equal --kernel torch's
        launches["qspa_stream_glayered"] = 0
        for method, ref in (("qspa", (598, 2304)),
                            ("layered_qspa", (872, 4096)),
                            ("glayered_qspa", None)):
            kernel = "qspa_stream_" + {"qspa": "flooding",
                                       "layered_qspa": "layered",
                                       "glayered_qspa": "glayered"}[method]
            got, n = drive(tmp, f"bds_stream_{method}", kernel,
                           bds12 + stream + ["--method", method],
                           no_plain=True)
            launches["qspa_stream_glayered" if method == "glayered_qspa"
                     else "qspa_stream"] += n
            if ref:
                anchor(f"bds_stream_{method}", "BDS.576.288.GF.64", 1.0,
                       got[0], ref)
            same_fer(f"bds_stream_{method}", got[:1], bds_batch[method])
            engine_rows.append((f"bds_stream_{method}", got[:1],
                                bds_batch[method]))
        got, _ = drive(tmp, "bds_packed", "qspa_layered",
                       bds12 + ["--packed", "--method", "layered_qspa"])
        anchor("bds_packed", "BDS.576.288.GF.64", 1.0, got[0], (872, 4096))
        got, n = drive(tmp, "bds_packed_stream", "qspa_stream_layered",
                       bds12 + stream + ["--packed", "--method",
                                         "layered_qspa"])
        launches["qspa_stream"] += n
        anchor("bds_packed_stream", "BDS.576.288.GF.64", 1.0, got[0],
               (872, 4096))

        # a stream sweep killed after its third collected call and resumed
        # from its checkpoint gives the uninterrupted run's rows
        j4s = ["binary", "--code", "J4_L24_Z96", "--snr", "3.2:0.4:3.6",
               "--snr-type", "ebn0", "--max-iters", "50", "--batch", "4096",
               "--least-error-frames", "50", "--least-test-frames", "16384",
               "--max-frames", "32768", *stream]
        full, n = drive(tmp, "j4_stream", "minsum_stream_flooding", j4s)
        launches["minsum_stream"] += n
        ck = os.path.join(tmp, "j4_stream.ck.json")
        sim._STREAM_TEST_INTERRUPT = 3
        try:
            _sweep(cli, os.path.join(tmp, "j4_killed"),
                   j4s + ["--checkpoint", ck])
        except KeyboardInterrupt:
            pass
        else:
            raise AssertionError("the stream sweep was not interrupted")
        finally:
            sim._STREAM_TEST_INTERRUPT = None
        resumed = _sweep(cli, os.path.join(tmp, "j4_resumed"),
                         j4s + ["--checkpoint", ck])
        counters = ("snr", "frames", "error_frames", "error_units",
                    "iter_sum", "false_frames", "alarm_frames")
        same = ([{k: r[k] for k in counters} for r in resumed]
                == [{k: r[k] for k in counters} for r in full])
        _emit("kill_resume", sweep="j4_stream", same_rows=same,
              rows=[{k: r[k] for k in counters} for r in resumed])
        if not same:
            raise AssertionError("the resumed stream sweep's rows differ")

        # a (code, method) pair with no stream kernel is refused on the card
        try:
            _sweep(cli, os.path.join(tmp, "refused_stream"),
                   tanner + stream + ["--method", "qspa"])
        except ValueError as e:
            if "ROADMAP.md Queue 1 item 13" not in str(e):
                raise
            _emit("refused", sweep="tanner qspa --engine stream",
                  error=str(e))
        else:
            raise AssertionError("the stream engine ran Tanner_74_9_Z128_"
                                 "GF16 under kernel auto")
        # ---- the max-domain decoders through the CLI: K8
        # VALIDATION.md:19, 23, 24 (2048 frames a point): ems 0.999 and
        # 0.7886, tmm 0.9805 and 0.5483, layered_tmm 0.5303 and 0.01465 at
        # Eb/N0 1 and 2 dB
        for label, kernel, method, refs in [
                ("bds_ems", "nbms_ems", None, ((2046, 2048), (1615, 2048))),
                ("bds_tmm", "nbms_tmm", "tmm", ((2008, 2048), (1123, 2048))),
                ("bds_layered_tmm", "nbms_layered_tmm", "layered_tmm",
                 ((1086, 2048), (30, 2048)))]:
            got, n = drive(tmp, label, kernel,
                           bds12 + (["--method", method] if method else []))
            launches[kernel] = n
            for r, ref in zip(got, refs):
                anchor(label, "BDS.576.288.GF.64", r["snr"], r, ref)
        # full EMS, VALIDATION.md:20: 0.3213 (2048 frames) at 1 dB, 3.562e-3
        # (8704 frames) at 2 dB; 2048 frames a point here (the batch that
        # meets the 1024-frame cap and the one in flight)
        got, n = drive(tmp, "bds_ems_full", "nbms_ems_full",
                       bds12[:bds12.index("--batch")]
                       + ["--batch", "1024", "--least-error-frames", "50",
                          "--least-test-frames", "1024", "--max-frames",
                          "1024", "--method", "ems_full"])
        launches["nbms_ems_full"] = n
        for r, ref in zip(got, ((658, 2048), (31, 8704))):
            anchor("bds_ems_full", "BDS.576.288.GF.64", r["snr"], r, ref)
        # EMS at other Nm/Nc: 64/3 is full EMS's function but for rounding
        # (Nm - 1 = q - 1 offsets, Nc = dc - 1 edges), so VALIDATION.md:20
        # again; 16/2 beside it, with no anchor
        nmnc = (bds12[:bds12.index("--batch")]
                + ["--batch", "1024", "--least-error-frames", "50",
                   "--least-test-frames", "1024", "--max-frames", "1024"])
        launches["nbms_ems_nmnc"] = 0
        for label, nm, nc, refs in [
                ("bds_ems_nm64_nc3", 64, 3, ((658, 2048), (31, 8704))),
                ("bds_ems_nm16_nc2", 16, 2, None)]:
            got, n = drive(tmp, label, "nbms_ems_nmnc",
                           nmnc + ["--nm", str(nm), "--nc", str(nc)],
                           no_plain=True)
            launches["nbms_ems_nmnc"] += n
            for r, ref in zip(got, refs or ()):
                anchor(label, "BDS.576.288.GF.64", r["snr"], r, ref)
        got, _ = drive(tmp, "bds_ems_packed", "nbms_ems", bds12 + ["--packed"])
        for r, ref in zip(got, ((2046, 2048), (1615, 2048))):
            anchor("bds_ems_packed", "BDS.576.288.GF.64", r["snr"], r, ref)
        try:
            _sweep(cli, os.path.join(tmp, "refused_ems_stream"),
                   bds12 + stream + ["--method", "ems"])
        except ValueError as e:
            if "ROADMAP.md Queue 1 item 20" not in str(e):
                raise
            _emit("refused", sweep="bds ems --engine stream", error=str(e))
        else:
            raise AssertionError("the stream engine ran ems under kernel "
                                 "auto")
        try:
            _sweep(cli, os.path.join(tmp, "refused_tanner_ems_full"),
                   tanner + ["--method", "ems_full"])
        except ValueError as e:
            if "ROADMAP.md Queue 1 item 19" not in str(e):
                raise
            _emit("refused", sweep="tanner ems_full", error=str(e))
        else:
            raise AssertionError("ems_full ran on Tanner_74_9_Z128_GF16 "
                                 "under kernel auto")
        try:
            _sweep(cli, os.path.join(tmp, "refused_tanner_glayered_tmm"),
                   tanner + ["--method", "glayered_tmm"])
        except ValueError as e:
            if "ROADMAP.md Queue 1 item 19" not in str(e):
                raise
            _emit("refused", sweep="tanner glayered_tmm", error=str(e))
        else:
            raise AssertionError("glayered_tmm ran on Tanner_74_9_Z128_GF16 "
                                 "under kernel auto")
        try:
            _sweep(cli, os.path.join(tmp, "refused_tanner_ems_nm4"),
                   tanner + ["--method", "ems", "--nm", "4"])
        except ValueError as e:
            if "ROADMAP.md Queue 1 item 19" not in str(e):
                raise
            _emit("refused", sweep="tanner ems --nm 4", error=str(e))
        else:
            raise AssertionError("ems --nm 4 ran on Tanner_74_9_Z128_GF16 "
                                 "under kernel auto")

        # the GF(q) committed workload (myNBLDPC/include/define.h:23-61),
        # capped here at 40,960 frames a point
        cap = 40960
        committed = ["nb", "--code", "BDS.576.288.GF.64", "--packed",
                     "--snr", "0:0.5:5", "--snr-type", "ebn0",
                     "--max-iters", "20", "--batch", "4096",
                     "--least-error-frames", "50", "--least-test-frames",
                     "1000", "--max-frames", str(cap)]
        t0 = time.perf_counter()
        grid, _ = drive(tmp, "bds_ems_committed", "nbms_ems", committed)
        grid_s = time.perf_counter() - t0
        met = [r["snr"] for r in grid
               if r["error_frames"] >= 50 and r["frames"] >= 1000]
        _emit("committed_gfq", points=len(grid), seconds=grid_s, cap=cap,
              stop_rule_met=met,
              capped=[r["snr"] for r in grid if r["snr"] not in met],
              card=card)
        if len(grid) != 11:
            raise AssertionError(f"the GF(q) grid has {len(grid)} points")
        for r in grid:
            if abs(r["snr"] - 1.0) < 1e-6:
                anchor("bds_ems_committed", "BDS.576.288.GF.64", 1.0, r,
                       (2046, 2048))
            elif abs(r["snr"] - 2.0) < 1e-6:
                anchor("bds_ems_committed", "BDS.576.288.GF.64", 2.0, r,
                       (1615, 2048))
            elif abs(r["snr"] - 3.0) < 1e-6:
                anchor("bds_ems_committed", "BDS.576.288.GF.64", 3.0, r,
                       (105, 2048))

        # random codewords through the CLI (--tx random, the syndrome
        # check): FERs compatible with the all-zero word's, as linearity
        # demands, and with the anchors.  J8_L24_Z96 at Eb/N0 2.53 dB,
        # 32768 frames each (VALIDATION.md:61-64: zero 371, random 360)
        random = ["--tx", "random", "--check", "syndrome"]
        j8 = ["binary", "--code", "J8_L24_Z96", "--snr", "2.53",
              "--snr-type", "ebn0", "--max-iters", "50", "--batch", "4096",
              "--least-error-frames", "50", "--least-test-frames", "32768",
              "--max-frames", "32768"]
        j8_zero, _ = drive(tmp, "j8_zero", "minsum_flooding", j8)
        j8_random, _ = drive(tmp, "j8_random", "minsum_flooding",
                             j8 + random)
        anchor("j8_zero", "J8_L24_Z96", 2.53, j8_zero[0], (371, 32768))
        anchor("j8_random", "J8_L24_Z96", 2.53, j8_random[0], (360, 32768))
        same_fer("j8_random_vs_zero", j8_random, j8_zero)
        # PON_LDPC in its waterfall, batch and stream, against the zero
        # word's batch rows
        got, _ = drive(tmp, "pon_random", "minsum_flooding", pon + random)
        same_fer("pon_random_vs_zero", got, pon_zero)
        got, n = drive(tmp, "pon_stream_random", "minsum_stream_flooding",
                       pon + stream + random)
        launches["minsum_stream"] += n
        same_fer("pon_stream_random_vs_zero", got, pon_zero)
        # GF(q): BDS qspa at 1 and 2 dB against VALIDATION.md:21-22, the
        # stream and packed engines and the default ems
        got, n = drive(tmp, "bds_qspa_random", "qspa_flooding",
                       bds_k5 + ["--method", "qspa", "--tx", "random"])
        launches["qspa_flooding"] += n
        anchor("bds_qspa_random", "BDS.576.288.GF.64", 1.0, got[0],
               (598, 2304))
        anchor("bds_qspa_random", "BDS.576.288.GF.64", 2.0, got[1],
               (54, 16640))
        got, n = drive(tmp, "bds_stream_random", "qspa_stream_flooding",
                       bds12 + stream + ["--method", "qspa", "--tx",
                                         "random"])
        launches["qspa_stream"] += n
        anchor("bds_stream_random", "BDS.576.288.GF.64", 1.0, got[0],
               (598, 2304))
        got, _ = drive(tmp, "bds_packed_random", "qspa_layered",
                       bds12 + ["--packed", "--method", "layered_qspa",
                                "--tx", "random"])
        anchor("bds_packed_random", "BDS.576.288.GF.64", 1.0, got[0],
               (872, 4096))
        got, n = drive(tmp, "bds_ems_random", "nbms_ems",
                       bds12 + ["--tx", "random"])
        launches["nbms_ems"] += n
        for r, ref in zip(got, ((2046, 2048), (1615, 2048))):
            anchor("bds_ems_random", "BDS.576.288.GF.64", r["snr"], r, ref)

        _emit("stream_vs_batch", card=card, info_mbps=[
            (label, [(a["snr"], a["info_mbps"], b["info_mbps"])
                     for a, b in zip(got, batch_rows)])
            for label, got, batch_rows in engine_rows])

    _emit("phase_seconds", name="main", seconds=time.perf_counter() - t_phase)

    # ---- 5. timing: 10 fixed iterations, one batch in flight
    t_phase = time.perf_counter()
    B, iters = 4096, 10
    timing = {}
    # the binary kernels on J15_L30_Z1280, each beside its bfloat16 form
    # ("bf16") and both plain versions, in turns; then K1 and K2 min-sum on
    # PON_LDPC against the plain version
    for name, code_name, plain_reps in (
            [(n, "J15_L30_Z1280", 3) for n, _, _ in BINARY]
            + [(f"minsum_{s}", "PON_LDPC", 2)
               for s in ("flooding", "layered")]):
        code = code_of(code_name)
        rule, schedule = name.split("_")
        chans = [chan_for(code, "esn0", -1.5, B, seed=7 + i, rule=rule)[0]
                 for i in range(2)]
        decoders = {"kernel": getattr(cuda_minsum, f"decode_{schedule}"),
                    "plain": getattr(minsum, f"decode_{schedule}")}
        reps = {"kernel": 20, "plain": plain_reps}
        order = ("plain", "kernel", "kernel", "plain")
        dtypes = {"kernel": None, "plain": None}
        on_j15 = code_name == "J15_L30_Z1280"
        if on_j15:
            decoders.update(bf16=decoders["kernel"],
                            plain_bf16=decoders["plain"])
            reps.update(bf16=20, plain_bf16=3)
            dtypes.update(bf16="bfloat16", plain_bf16="bfloat16")
            order = ("plain", "plain_bf16", "kernel", "bf16", "bf16",
                     "kernel", "plain_bf16", "plain")

        def launch(which, i):
            return decoders[which](chans[i % 2], code, iters, check="zero",
                                   early_stop=False, rule=rule,
                                   msg_dtype=dtypes[which])

        runs = time_turns(launch, reps, order=order)
        ms = {k: statistics.median(v) for k, v in runs.items()}
        bound, bound_by = bound_ms(code, B, iters, schedule, rule, "zero")
        label = name if on_j15 else f"{name} pon"
        bounds = {"float32": (bound, bound_by)}
        if on_j15:
            timing[name] = (ms, bound, bound_by)
            bounds["bfloat16"] = bound_ms(code, B, iters, schedule, rule,
                                          "zero", bf16=True)
            timing[f"{name}_bf16"] = (
                {"kernel": ms["bf16"], "plain": ms["plain_bf16"]},
                *bounds["bfloat16"])
        _emit("timing", kernel=label, code=code.name, batch=B, iters=iters,
              card=card, ms_per_batch=runs,
              info_mbps={k: B * code.k / (v / 1e3) / 1e6
                         for k, v in ms.items()},
              bound_ms=bound, bound_by=bound_by, bounds=bounds)
        if on_j15:
            # where each form's time goes: device time per CUDA kernel of
            # one decode call, from torch.profiler
            for which in ("kernel", "bf16"):
                device_ms = profile_ms(lambda: launch(which, 0))
                _emit("profile", kernel=name + ("_bf16" if which == "bf16"
                                                else ""),
                      code=code.name, batch=B, iters=iters, card=card,
                      device_ms_total=sum(v[0] for v in device_ms.values()),
                      device_ms_launches=device_ms)
        del chans
        torch.cuda.empty_cache()

    # GF(q): at most 10 passes, early stop off, below the waterfall so that
    # most frames run every pass (each frame still stops when it passes)
    nb_timing = [
        # kernel, code, Eb/N0, batch, plain reps
        ("qspa_flooding", "BDS.576.288.GF.64", 0.0, 4096, 3),
        ("qspa_layered", "BDS.576.288.GF.64", 0.0, 4096, 3),
        ("qspa_glayered", "BDS.576.288.GF.64", 0.0, 4096, 3),
        ("qspa_qc_flooding", "Tanner_74_9_Z128_GF16", 3.0, 256, 3),
        ("qspa_qc_layered", "Tanner_74_9_Z128_GF16", 3.0, 256, 3),
    ]
    for name, code_name, ebn0, B, plain_reps in nb_timing:
        code = nb_code(code_name)
        chans = [nb_chan(code, ebn0, B, seed=17 + i)[0] for i in range(2)]
        decoders = dict(zip(("kernel", "plain"), nb_pairs[name]))
        reps = {"kernel": 20, "plain": plain_reps}
        order = ("plain", "kernel", "kernel", "plain")
        if name.startswith("qspa_qc"):
            # K6: the staged kernel against the global design, in turns
            decoders["global"] = getattr(
                cuda_qspa_qc, f"decode_{name[len('qspa_qc_'):]}_global")
            reps["global"] = 20
            order = ("plain", "kernel", "global", "global", "kernel", "plain")
        else:
            # K5: where the rule puts a row on one warp, against a warp an
            # edge; grouped-layered also against the serial-row layered
            # kernel; in turns
            lay, plan = name.endswith("layered"), cuda_qspa.make_plan(code)
            schedule = name[len("qspa_"):]
            yards = []
            if cuda_qspa.row_layout(plan) == "warp":
                yards.append("groups")
                decoders["groups"] = functools.partial(
                    cuda_qspa.decode_design, schedule=schedule,
                    design="groups")
            if schedule == "glayered":
                yards.append("layered")
                decoders["layered"] = cuda_qspa.decode_layered
            reps.update({d: 20 for d in yards})
            order = ("plain", "kernel", *yards, *yards[::-1], "kernel",
                     "plain")
            shapes = {d: {"shape": cuda_qspa.launch_shape(plan, lay, d),
                          "blocks_per_sm": cuda_qspa.blocks_per_sm(
                              plan, lay, d, dev)}
                      for d in ("warp", "groups")
                      if d != "warp" or "groups" in yards}

        def launch(which, i):
            return decoders[which](chans[i % 2], code, iters,
                                   early_stop=False)

        runs = time_turns(launch, reps, order=order)
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
              layout=(None if name.startswith("qspa_qc")
                      else cuda_qspa.row_layout(plan)),
              designs=None if name.startswith("qspa_qc") else shapes,
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

    # K4: B=4096, one call of 10 passes where no slot converges (max_iters
    # out of reach; J15_L30_Z1280 at Es/N0 -3 dB, PON_LDPC at 0 dB), so
    # every call does the work of K1/K2's 10 fixed iterations.  Min-sum with
    # the state on chip ("kernel"), the global-memory design ("global") and
    # the plain version in turns, and J15_L30_Z1280 flooding on a cluster of
    # 4 that holds chan too ("cluster4")
    B, k = 4096, 10
    zeros = lambda: torch.zeros(B, dtype=torch.int32, device=dev)  # noqa: E731
    for key, name, snr, rule, layered in (
            ("minsum_stream", "J15_L30_Z1280", -3.0, "minsum", False),
            ("minsum_stream layered", "J15_L30_Z1280", -3.0, "minsum", True),
            ("bp_stream", "J15_L30_Z1280", -3.0, "bp", False),
            ("minsum_stream pon", "PON_LDPC", 0.0, "minsum", False),
            ("minsum_stream pon layered", "PON_LDPC", 0.0, "minsum", True)):
        code = code_of(name)
        chan0 = chan_for(code, "esn0", snr, B, seed=27, rule=rule)[0]
        steps = {"kernel": cuda_minsum_stream.stream_step,
                 "plain": minsum_stream.stream_step}
        plans = {}
        if rule == "minsum":
            steps["global"] = cuda_minsum_stream.global_stream_step
            plans["kernel"] = onchip.onchip_plan(code, layered)
            if name == "J15_L30_Z1280" and not layered:
                steps["cluster4"] = functools.partial(
                    cuda_minsum_stream.onchip_step,
                    plan=onchip.onchip_plan(code, False, cluster=4))
                plans["cluster4"] = steps["cluster4"].keywords["plan"]
        states = {w: [chan0.clone(), torch.zeros((B, code.num_edges, code.Z),
                                                 device=dev),
                      zeros(), zeros(), zeros()] for w in steps}

        def launch(which, i):
            kw = {} if which == "cluster4" else dict(rule=rule)
            return steps[which](*states[which], code, k, 10**6, check="zero",
                                layered=layered, **kw)

        reps = {w: 20 for w in steps}
        reps["plain"] = 3
        order = ("plain", *[w for w in steps if w != "plain"])
        runs = time_turns(launch, reps, order=order + order[::-1])
        ms = {w: statistics.median(v) for w, v in runs.items()}
        t0_, d0 = states["kernel"][2].clone(), states["kernel"][3].clone()
        launch("kernel", 0)
        updates = int((states["kernel"][2] - t0_).sum())
        passes = updates + int((states["kernel"][3] - d0).sum())
        bound, bound_by = stream_bound_ms(code, B, passes, updates, layered,
                                          rule, "zero")
        if key == "minsum_stream":
            timing[key] = (ms, bound, bound_by)
        _emit("timing", kernel=key, code=code.name, batch=B, passes=k,
              card=card, ms_per_call=runs, slot_passes=passes,
              slot_updates=updates,
              plans={w: {"cluster": p.cluster, "keep_chan": p.keep_chan,
                         "smem_bytes": p.smem_bytes}
                     for w, p in plans.items()},
              info_mbps_per_10_passes={w: B * code.k / (v / 1e3) / 1e6
                                       for w, v in ms.items()},
              bound_ms=bound, bound_by=bound_by)
        del states, chan0
        torch.cuda.empty_cache()
    code = code_of("J15_L30_Z1280")

    # the refill between two K4 calls: a fresh channel for all B slots and
    # the select into the finished ones
    scfg = cfg.BinarySimConfig(code=code.name, batch_per_device=B)
    fresh = sim._binary_source(code, scfg, B, dev)
    chan = fresh(torch.Generator(device=dev).manual_seed(1), 0.9)[0]
    fin = torch.rand(B, device=dev) < 0.5
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    fresh(torch.Generator(device=dev).manual_seed(2), 0.9)
    events[0].record()
    for i in range(10):
        new = fresh(torch.Generator(device=dev).manual_seed(3 + i), 0.9)[0]
        chan = torch.where(fin[:, None, None], new, chan)
    events[1].record()
    events[1].synchronize()
    _emit("refill", code=code.name, batch=B, normals=B * code.n, card=card,
          ms_per_refill=events[0].elapsed_time(events[1]) / 10)
    del chan, new
    torch.cuda.empty_cache()

    # K7: BDS.576.288.GF.64, B=4096, at most 10 passes from fresh slots at
    # 0 dB (max_iters 9: 10 decides and 9 updates for a slot that never
    # passes, as K5's 10 iterations), each call resetting its state; the
    # kernel and the plain version in turns, each schedule
    code = nb_code("BDS.576.288.GF.64")
    E = int(code.cn_mask.sum())
    chan0 = nb_chan(code, 0.0, B, seed=37)[0]
    for layered in (False, True, "glayered"):
        steps = {"kernel": cuda_qspa_stream.stream_step,
                 "plain": qspa_stream.stream_step}
        states = {w: [chan0.clone(), torch.zeros((B, E, code.q), device=dev),
                      zeros(), zeros(), zeros()] for w in steps}

        def launch(which, i):
            st = states[which]
            st[0].copy_(chan0)
            for x in st[1:]:
                x.zero_()
            return steps[which](*st, code, 10, 9, layered=layered)

        runs = time_turns(launch, {"kernel": 20, "plain": 3})
        ms = {w: statistics.median(v) for w, v in runs.items()}
        launch("kernel", 0)
        st = states["kernel"]
        updates, finished = int(st[2].sum()), int(st[3].sum())
        bound, bound_by = qspa_stream_bound_ms(code.n_sym, E, code.q, B,
                                               updates + finished, updates,
                                               bool(layered))
        schedule = qspa_stream.schedule(layered)
        if schedule != "layered":
            timing["qspa_stream" + ("_glayered" if layered else "")] = (
                ms, bound, bound_by)
        _emit("timing", kernel="qspa_stream" + ("" if schedule == "flooding"
                                                 else f" {schedule}"),
              code=code.name, batch=B, ebn0=0.0, max_passes=10, card=card,
              groups=cuda_qspa_stream.groups(cuda_qspa.make_plan(code),
                                            bool(layered)),
              ms_per_call=runs, slot_passes=updates + finished,
              slot_updates=updates,
              info_mbps={w: B * code.k_sym * code.q_bit / (v / 1e3) / 1e6
                         for w, v in ms.items()},
              bound_ms=bound, bound_by=bound_by)
        del states
        torch.cuda.empty_cache()

    # K8: BDS.576.288.GF.64, B=4096, at most 10 passes at 0 dB from fresh
    # frames, each method's kernel and plain version in turns (plain,
    # kernel, kernel, plain); the plain layered TMM and full EMS take
    # seconds a call, so one call a turn
    code, B, iters = nb_code("BDS.576.288.GF.64"), 4096, 10
    chans = [nb_chan(code, 0.0, B, seed=47 + i)[0] for i in range(2)]
    plan = cuda_nbms.make_plan(code)
    for key, (kernel, plain) in k8_pairs.items():
        decoders = {"kernel": kernel, "plain": plain}
        reps = {"plain": 1 if key in ("nbms_layered_tmm", "nbms_ems_full")
                else 3, "kernel": 20}
        order = ("plain", "kernel", "kernel", "plain")
        if key == "nbms_glayered_tmm":
            # against the serial-row layered TMM kernel, in turns
            decoders["layered"] = cuda_nbms.decode_layered_tmm
            reps["layered"] = 20
            order = ("plain", "kernel", "layered", "layered", "kernel",
                     "plain")
        if key in YARDSTICKS:
            # against its earlier design, in turns
            decoders["yardstick"] = cuda_nbms.decode_ems_full_dense
            reps["yardstick"] = 20
            order = ("plain", "kernel", "yardstick", "yardstick", "kernel",
                     "plain")

        def launch(which, i):
            return decoders[which](chans[i % 2], code, iters)

        runs = time_turns(launch, reps, order=order)
        ms = {k: statistics.median(v) for k, v in runs.items()}
        res = launch("kernel", 0)
        bound, bound_by = nbms_bound_ms(code.n_sym, code.m_sym, plan.E,
                                        code.q, B, res.iters.tolist(), iters,
                                        key[len("nbms_"):])
        timing[key] = (ms, bound, bound_by)
        _emit("timing", kernel=key, code=code.name, batch=B, ebn0=0.0,
              max_passes=iters, avg_iters=float(res.iters.float().mean()),
              card=card, groups=cuda_nbms.groups(plan, key[len("nbms_"):]),
              ms_per_batch=runs,
              info_mbps={k: B * code.k_sym * code.q_bit / (v / 1e3) / 1e6
                         for k, v in ms.items()},
              bound_ms=bound, bound_by=bound_by)
        del res
        torch.cuda.empty_cache()
    # EMS at other Nm/Nc (the mode ems_nmnc) on the same frames, the plain
    # version (1.4-7 s a call) timed once; then the budgeted chains on
    # LDPC_N576_K480_GF256_exp at a batch the plain version holds (64).
    # The kernels line takes Nm/Nc 64/3, the main path's anchored sweep.
    k480 = nb_code("LDPC_N576_K480_GF256_exp")
    for tcode, tB, nm, nc in [(code, B, 16, 2), (code, B, 64, 3),
                              (k480, 64, 8, 10)]:
        tchans = (chans if tcode is code
                  else [nb_chan(tcode, 0.0, tB, seed=57 + i)[0]
                        for i in range(2)])
        decoders = {
            "kernel": functools.partial(cuda_nbms.decode_ems, nm=nm, nc=nc),
            "yardstick": functools.partial(cuda_nbms.decode_ems_nmnc_dense,
                                           nm=nm, nc=nc),
            "plain": functools.partial(nb_decode.decode_ems, nm=nm, nc=nc)}

        def launch(which, i):
            return decoders[which](tchans[i % 2], tcode, iters)

        runs = time_turns(launch, {"plain": 1, "kernel": 10, "yardstick": 10},
                          order=("plain", "kernel", "yardstick", "yardstick",
                                 "kernel"))
        ms = {k: statistics.median(v) for k, v in runs.items()}
        res = launch("kernel", 0)
        tplan = cuda_nbms.make_plan(tcode)
        bound, bound_by = nbms_bound_ms(tcode.n_sym, tcode.m_sym, tplan.E,
                                        tcode.q, tB, res.iters.tolist(),
                                        iters, "ems_nmnc", nm, nc)
        if (tcode, nm, nc) == (code, 64, 3):
            timing["nbms_ems_nmnc"] = (ms, bound, bound_by)
        _emit("timing", kernel="nbms_ems_nmnc", code=tcode.name, nm=nm,
              nc=nc, branch=cuda_nbms.ems_branch(nm, nc, tcode.max_dc),
              batch=tB, ebn0=0.0, max_passes=iters,
              avg_iters=float(res.iters.float().mean()), card=card,
              groups=cuda_nbms.groups(tplan, "ems_nmnc", nm, nc),
              ms_per_batch=runs,
              info_mbps={k: tB * tcode.k_sym * tcode.q_bit / (v / 1e3) / 1e6
                         for k, v in ms.items()},
              bound_ms=bound, bound_by=bound_by)
        del res, tchans
        torch.cuda.empty_cache()
    del chans
    encode_timing(dev, card)

    _emit("phase_seconds", name="timing",
          seconds=time.perf_counter() - t_phase)

    # ---- 6. the measuring path and the probes
    t_phase = time.perf_counter()
    measuring_path(card, wrappers)
    _emit("phase_seconds", name="measuring_path",
          seconds=time.perf_counter() - t_phase)
    t_phase = time.perf_counter()
    for key, got in probes(card, lib_path).items():
        launches[key] = got["launches"]
        max_err[key] = got["max_abs_err"]
        mismatches[key] = got["mismatches"]
        timing[key] = got["timing"]

    _emit("phase_seconds", name="probes",
          seconds=time.perf_counter() - t_phase)

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
