"""Where the binary stream kernel K4's time goes, phase by phase, on a card.

    python -m cuda_ldpc_torch.tools.stream_phases [--batch 4096] [--passes 10]

It builds, into the git-ignored build directory, a copy of the kernels whose
on-chip min-sum stream kernel (csrc/minsum_stream.cu, ``onchip_kernel``,
which places the barriers between csrc/onchip.cuh's phases) reads clock64()
at its phase boundaries: thread 0 of every block adds the
cycles since its previous boundary to a device counter per phase (entry,
VN, check, CN, a layered row, exit, and the barrier after each).  One call
of ``passes`` passes, B = ``batch``, at an SNR where no slot converges, on
J15_L30_Z1280 (a cluster of two blocks) and PON_LDPC (one block), flooding
and layered, gives each phase's share of the summed cycles; the call's time
with the counters and without them (the library the package builds) is
printed beside it.  Thread 0's view: a phase's share holds that thread's
own work, and the barrier after it the wait for the rest of the cluster.

It also times a barrier, ``__syncthreads()`` against a cluster barrier
(``cluster.sync()``), in a grid of one block an SM, clusters of 1, 2 and
4 blocks of 256, 512 and 1024 threads: CUDA events around a kernel of
20,000 barriers.

Needs a CUDA device and nvcc; prints one JSON line per measurement, each
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

PHASES = {1: "entry", 2: "entry_barrier", 3: "vn", 4: "vn_barrier",
          5: "check", 6: "cn", 7: "cn_barrier", 8: "row", 9: "row_barrier",
          10: "exit", 11: "exit_barrier"}

_COUNTERS = (
    "__device__ unsigned long long g_phase_clk[16];\n"
    "#define PHASE_CLK(n) if (threadIdx.x == 0) { "
    "unsigned long long _n = clock64(); "
    "atomicAdd(&g_phase_clk[n], _n - _last); _last = _n; }\n")

# (anchor in csrc/minsum_stream.cu, text, True: before its last occurrence,
# False: after it)
_PATCHES = [
    ("// kLocal: a cluster of one block", _COUNTERS, True),
    ("    int t = t_io[b], done = done_io[b], okf = okf_io[b];\n",
     "    unsigned long long _last = clock64();\n", False),
    ("    sync_all<kLocal>(cluster);\n\n    // the zero check",
     "    PHASE_CLK(1)\n", True),
    ("    // the zero check", "    PHASE_CLK(2)\n", True),
    ("        if (zero_in_vn) publish_bad", "        PHASE_CLK(3)\n", True),
    ("        if (zero_in_vn) bad = gather_bad", "        PHASE_CLK(4)\n",
     True),
    ("      if (!done && (!bad || t >= max_iters)) {", "      PHASE_CLK(5)\n",
     True),
    ("        sync_all<kLocal>(cluster);  // the next totals read every",
     "        PHASE_CLK(6)\n", True),
    ("        sync_all<kLocal>(cluster);  // the next totals read every row's "
     "state\n", "        PHASE_CLK(7)\n", False),
    ("          sync_all<kLocal>(cluster);  // the next row reads these",
     "          PHASE_CLK(8)\n", True),
    ("          sync_all<kLocal>(cluster);  // the next row reads these "
     "totals\n", "          PHASE_CLK(9)\n", False),
    ("    sync_all<kLocal>(cluster);  // no block reuses",
     "    PHASE_CLK(10)\n", True),
    ("    sync_all<kLocal>(cluster);  // no block reuses its memory while a "
     "peer reads\n", "    PHASE_CLK(11)\n", False),
]

_READ_COUNTERS = """
extern "C" int ldpc_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clk,
                                         sizeof(g_phase_clk));
  if (err) return err;
  unsigned long long zero[16] = {0};
  return cudaMemcpyToSymbol(g_phase_clk, zero, sizeof(zero));
}
"""

_BARRIER_SRC = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
static __global__ void barriers(int n, int cluster_barrier, int* out) {
  cg::cluster_group cl = cg::this_cluster();
  int acc = 0;
  for (int i = 0; i < n; ++i) {
    if (cluster_barrier) cl.sync(); else __syncthreads();
    acc += threadIdx.x;
  }
  if (acc == -1) out[0] = acc;
}
extern "C" int ldpc_barrier_ms(int blocks, int cluster, int threads,
                               int cluster_barrier, int n, float* ms) {
  int* out;
  cudaError_t err = cudaMalloc(&out, sizeof(int));
  if (err) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks / cluster * cluster);
  cfg.blockDim = dim3(threads);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaLaunchKernelEx(&cfg, barriers, n, cluster_barrier, out);
  cudaEventRecord(e0);
  cudaLaunchKernelEx(&cfg, barriers, n, cluster_barrier, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  return cudaGetLastError();
}
"""


def patched_source(src: str) -> str:
    """csrc/minsum_stream.cu with the phase counters; raises ValueError when
    an anchor is gone (the kernel changed under the tool)."""
    for anchor, text, before in _PATCHES:
        i = src.rfind(anchor)
        if i < 0:
            raise ValueError(f"anchor not in minsum_stream.cu: {anchor!r}")
        j = i if before else i + len(anchor)
        src = src[:j] + text + src[j:]
    return src + _READ_COUNTERS


def _instrumented_lib(root: pathlib.Path):
    """The package's library built from the patched sources under root."""
    from cuda_ldpc_torch.ops import _build
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, csrc)
    (csrc / "minsum_stream.cu").write_text(
        patched_source((csrc / "minsum_stream.cu").read_text()))
    saved = _build.CSRC_DIR, _build.BUILD_DIR
    try:
        _build.CSRC_DIR, _build.BUILD_DIR = csrc, root / "build"
        lib = _build._bind(ctypes.CDLL(str(_build.build())))
    finally:
        _build.CSRC_DIR, _build.BUILD_DIR = saved
    lib.ldpc_phase_clocks.argtypes = [ctypes.c_void_p]
    lib.ldpc_phase_clocks.restype = ctypes.c_int
    return lib


def _barrier_lib(root: pathlib.Path):
    from cuda_ldpc_torch.ops import _build
    src, so = root / "barriers.cu", root / "libbarriers.so"
    src.write_text(_BARRIER_SRC)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.ldpc_barrier_ms.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.ldpc_barrier_ms.restype = ctypes.c_int
    return lib


def measure(batch: int = 4096, passes: int = 10):
    """Yield one dict per measurement (see the module docstring)."""
    import torch

    from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
    from cuda_ldpc_torch.ops import (_build, channel, cuda_minsum_stream,
                                     onchip)
    from cuda_ldpc_torch.utils.timing import time_ms

    dev = torch.device("cuda", 0)
    root = _build.BUILD_DIR / "stream_phases"
    root.mkdir(parents=True, exist_ok=True)
    plain_lib = _build.load()
    lib = _instrumented_lib(root)
    clocks = (ctypes.c_ulonglong * 16)()
    # Es/N0 where no slot converges in `passes` passes
    for name, esn0 in (("J15_L30_Z1280", -3.0), ("PON_LDPC", 0.0)):
        code = QCBinaryCode.from_registry(name)
        sigma = channel.sigma_from_snr(esn0, code.rate, "esn0")
        g = torch.Generator(device=dev).manual_seed(27)
        chan = channel.bpsk_awgn_llr(
            g, torch.zeros(code.L, code.Z, device=dev), sigma, batch)
        for layered in (False, True):
            z = torch.zeros(batch, dtype=torch.int32, device=dev)
            state = [chan.clone(), torch.zeros(
                (batch, code.num_edges, code.Z), device=dev), z, z.clone(),
                z.clone()]

            def call():
                cuda_minsum_stream.onchip_step(*state, code, passes, 10**6,
                                               check="zero", layered=layered)

            plan = onchip.onchip_plan(code, layered)
            ms = {}
            try:
                for which, use in (("plain", plain_lib), ("counted", lib)):
                    _build._lib = use
                    ms[which] = time_ms(call, dev, reps=3)
                lib.ldpc_phase_clocks(clocks)        # drop the timed calls
                _build._lib = lib
                call()
                torch.cuda.synchronize(dev)
            finally:
                _build._lib = plain_lib
            if lib.ldpc_phase_clocks(clocks):
                raise RuntimeError("reading the phase counters failed")
            total = sum(clocks[i] for i in PHASES)
            yield {"code": name, "layered": layered, "batch": batch,
                   "passes": passes, "cluster": plan.cluster,
                   "threads": plan.threads, "ms": ms["plain"],
                   "ms_with_counters": ms["counted"],
                   "share": {PHASES[i]: clocks[i] / total for i in PHASES
                             if clocks[i]}}
    blib = _barrier_lib(root)
    n, out = 20000, ctypes.c_float()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for cluster in (1, 2, 4):
        for threads in (256, 512, 1024):
            row = {"barrier": True, "cluster": cluster, "threads": threads}
            for key, mode in (("block_ns", 0), ("cluster_ns", 1)):
                if blib.ldpc_barrier_ms(sms, cluster, threads, mode, n,
                                        ctypes.byref(out)):
                    raise RuntimeError("the barrier kernel failed")
                row[key] = out.value * 1e6 / n
            yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "cuda_ldpc_torch.tools.stream_phases")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--passes", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("stream_phases: needs a CUDA device", file=sys.stderr)
        return 1
    from cuda_ldpc_torch.utils.device import card_info
    card = card_info()
    for row in measure(args.batch, args.passes):
        print(json.dumps({"card": card, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
