"""Where the time of the GF(q) QSPA decoder K5 (flooding, layered,
grouped-layered), of the max-domain decoder K8 (EMS, EMS at other Nm/Nc,
full EMS, TMM, layered TMM, grouped-layered TMM) and of the GF(q) QSPA
stream step K7 (flooding, layered, grouped-layered) goes, phase by phase,
on a card.

    python -m cuda_ldpc_torch.tools.nb_rows_phases [--batch 4096]
        [--passes 10] [--ebn0 0.0] [--code BDS.576.288.GF.64]
        [--designs groups,warp]
        [--kernels qspa,qspa_layered,...] [--groups 1,2,4] [--warps 2,4,8]
        [--nm 16 --nc 2]

It builds, into the git-ignored build directory, a copy of the kernels with
csrc/qspa.cu, csrc/nbms.cu and csrc/qspa_stream.cu compiled under
``NB_ROWS_PHASES``: thread 0 of every block reads clock64() at the phase
boundaries of csrc/qspa_common.cuh's ``RowsPhase`` and adds the cycles since
its previous stamp to a per-block counter, flushed to a device counter per
method or schedule when the block ends (the grouped-layered schedules share
the layered counters: they run the layered code).  One call of at most
``passes`` passes on B = ``batch`` frames of ``code`` (an adjacency code, by
default BDS.576.288.GF.64) at Eb/N0 ``ebn0`` dB, BPSK (chip_smoke.py's
timing point: K5 and K8 decode fresh frames; K7 starts from fresh slots
with max_iters = passes - 1), gives each phase's share of the summed
cycles, for each design: the row groups (a warp an edge; K8's
``decode_*``, K7's ``stream_step``; K5's ``decode_design(..., 'groups')``,
one group) and K5's row on one warp (``decode_design(..., 'warp')``).
K8's full EMS counts its forward/backward chains under ``search`` and its
exclusive convolutions under ``merge``; its EMS at ``--nm``/``--nc``
(``nbms_ems_nmnc``, the mode ``ems_nmnc``) the single deviations and the
top Nm - 1 selection under ``mins``, the pairs or the chains under
``search``, the exclusive convolutions under ``merge``; the earlier
designs of both (``nbms_ems_full_dense``, ``nbms_ems_nmnc_dense``, the
yardstick) on counters of their own, for the two designs' phases side by
side.  The call's time
with the counters and without them (the library the package builds) and
the blocks an SM holds (CUDA's occupancy calculator) are printed beside it.
``--groups`` also times K7's and K8's row groups at each listed number of
groups (the package picks its own: ``cuda_nbms.groups``,
``cuda_qspa_stream.groups``; K5 is built for one group), ``--warps`` K5's
row on one warp at each listed number of warps a block within the
schedule's launch bound (the package's: ``cuda_qspa.warps``).
Thread 0's view: it is in group 0 (warp 0), so a row phase is group 0's
work and a wait its barrier's.

Needs a CUDA device and nvcc; prints one JSON line per measurement, each
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import sys

# csrc/qspa_common.cuh's RowsPhase enum, in order
PHASES = ("setup", "totals", "decide", "edges", "edges_wait", "mins",
          "search", "merge", "output", "row_wait", "wave_wait", "exit")
# the instrumented sources and their counter readers: (file, function,
# counters)
SOURCES = (("qspa.cu", "ldpc_qspa_phase_clocks", 2),
           ("nbms.cu", "ldpc_nbms_phase_clocks", 7),
           ("qspa_stream.cu", "ldpc_qspa_stream_phase_clocks", 2))
# kernel -> (counter reader, its row, K8's decoder or K5's / K7's schedule)
KERNELS = {
    "qspa": ("ldpc_qspa_phase_clocks", 0, "flooding"),
    "qspa_layered": ("ldpc_qspa_phase_clocks", 1, "layered"),
    "qspa_glayered": ("ldpc_qspa_phase_clocks", 1, "glayered"),
    "nbms_ems": ("ldpc_nbms_phase_clocks", 0, "decode_ems"),
    "nbms_tmm": ("ldpc_nbms_phase_clocks", 1, "decode_tmm"),
    "nbms_layered_tmm": ("ldpc_nbms_phase_clocks", 2, "decode_layered_tmm"),
    "nbms_glayered_tmm": ("ldpc_nbms_phase_clocks", 2,
                          "decode_glayered_tmm"),
    "nbms_ems_full": ("ldpc_nbms_phase_clocks", 3, "decode_ems_full"),
    "nbms_ems_nmnc": ("ldpc_nbms_phase_clocks", 4, "decode_ems"),
    "nbms_ems_full_dense": ("ldpc_nbms_phase_clocks", 5,
                            "decode_ems_full_dense"),
    "nbms_ems_nmnc_dense": ("ldpc_nbms_phase_clocks", 6,
                            "decode_ems_nmnc_dense"),
    "qspa_stream": ("ldpc_qspa_stream_phase_clocks", 0, "flooding"),
    "qspa_stream_layered": ("ldpc_qspa_stream_phase_clocks", 1, "layered"),
    "qspa_stream_glayered": ("ldpc_qspa_stream_phase_clocks", 1,
                             "glayered"),
}
DESIGNS = ("groups", "warp")
# the kernels that take EMS's Nm and Nc
NMNC = ("nbms_ems_nmnc", "nbms_ems_nmnc_dense")


def phase_names(src: str) -> tuple:
    """The RowsPhase enum's names in csrc/qspa_common.cuh's text, lower case
    without the ``kRp`` prefix and without kRpCount."""
    body = re.search(r"enum RowsPhase \{(.*?)\};", src, re.S)
    if body is None:
        raise ValueError("no RowsPhase enum in qspa_common.cuh")
    names = re.findall(r"kRp(\w+)", body.group(1))
    snake = [re.sub(r"(?<!^)([A-Z])", r"_\1", n).lower() for n in names]
    return tuple(n for n in snake if n != "count")


def patched_source(src: str, common: str) -> str:
    """A kernel source with the phase counters compiled in; raises
    ValueError when the RowsPhase enum is not the one this tool reads."""
    if phase_names(common) != PHASES:
        raise ValueError(f"qspa_common.cuh's phases {phase_names(common)} "
                         f"are not {PHASES}")
    return "#define NB_ROWS_PHASES 1\n" + src


def _instrumented_lib(root: pathlib.Path):
    """The package's library built from the patched sources under root."""
    from cuda_ldpc_torch.ops import _build
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, csrc)
    common = (csrc / "qspa_common.cuh").read_text()
    for name, _, _ in SOURCES:
        (csrc / name).write_text(patched_source((csrc / name).read_text(),
                                                common))
    saved = _build.CSRC_DIR, _build.BUILD_DIR
    try:
        _build.CSRC_DIR, _build.BUILD_DIR = csrc, root / "build"
        lib = _build._bind(ctypes.CDLL(str(_build.build())))
    finally:
        _build.CSRC_DIR, _build.BUILD_DIR = saved
    for _, fn, _ in SOURCES:
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _calls(code, L, passes, kernels, nm=16, nc=2):
    """kernel -> {design: call()} for each design the kernel has, each
    call starting from the same state (EMS at other Nm/Nc at nm, nc)."""
    import torch

    from cuda_ldpc_torch.ops import cuda_nbms, cuda_qspa, cuda_qspa_stream
    B, dev = L.shape[0], L.device
    E = int(code.cn_mask.sum())
    out = {}
    for kernel in kernels:
        what = KERNELS[kernel][2]
        if kernel.startswith("qspa") and not kernel.startswith("qspa_stream"):
            designs = [d for d in DESIGNS if d != "warp"
                       or cuda_qspa.warp_fits(cuda_qspa.make_plan(code))]
            out[kernel] = {d: (lambda d=d, s=what:
                               cuda_qspa.decode_design(L, code, passes, s, d))
                           for d in designs}
            continue
        if kernel.startswith("nbms"):
            kw = {"nm": nm, "nc": nc} if kernel in NMNC else {}
            out[kernel] = {"groups": (lambda f=getattr(cuda_nbms, what), kw=kw:
                                      f(L, code, passes, **kw))}
            continue
        state = [torch.empty_like(L), torch.empty((B, E, code.q), device=dev)]
        state += [torch.empty(B, dtype=torch.int32, device=dev)
                  for _ in range(3)]
        layered = {"flooding": False, "layered": True}.get(what, what)

        def step(layered=layered, state=state):
            state[0].copy_(L)
            for x in state[1:]:
                x.zero_()
            return cuda_qspa_stream.stream_step(*state, code, passes,
                                                passes - 1, layered=layered)

        out[kernel] = {"groups": step}
    return out


def measure(batch: int = 4096, passes: int = 10, ebn0: float = 0.0,
            designs=DESIGNS, groups=(), warps=(), kernels=tuple(KERNELS),
            code_name="BDS.576.288.GF.64", nm: int = 16, nc: int = 2):
    """Yield one dict per kernel and design (see the module docstring), then
    one per kernel and listed number of groups, then one per K5 schedule
    and listed number of warps."""
    import numpy as np
    import torch

    from cuda_ldpc_torch.models.nb_code import NBCode
    from cuda_ldpc_torch.ops import (_build, channel, cuda_nbms, cuda_qspa,
                                     cuda_qspa_stream, demod)
    from cuda_ldpc_torch.utils.constellations import constellation
    from cuda_ldpc_torch.utils.timing import time_ms

    dev = torch.device("cuda", 0)
    root = _build.BUILD_DIR / "nb_rows_phases"
    root.mkdir(parents=True, exist_ok=True)
    plain_lib = _build.load()
    lib = _instrumented_lib(root)
    code = NBCode.from_registry(code_name)
    plan = cuda_qspa.make_plan(code)
    sigma = channel.sigma_from_snr(ebn0, code.rate, "ebn0", 1.0)
    g = torch.Generator(device=dev).manual_seed(47)
    L = demod.nb_channel_llr(g, np.zeros(code.bit_length, dtype=np.int64),
                             constellation(2), sigma, batch, code.q,
                             device=dev)
    calls = _calls(code, L, passes, kernels, nm, nc)

    def module(kernel):
        return (cuda_nbms if kernel.startswith("nbms") else cuda_qspa_stream
                if kernel.startswith("qspa_stream") else cuda_qspa)

    def arg(kernel):
        """The method (K8) or whether the schedule is layered (K5, K7), as
        the modules take them."""
        return (kernel[len("nbms_"):] if kernel.startswith("nbms")
                else kernel.endswith("layered"))

    def extra(kernel):
        return {"nm": nm, "nc": nc} if kernel in NMNC else {}

    def shape(kernel, design):
        """The design's groups or warps, and the blocks an SM holds."""
        if module(kernel) is cuda_qspa:
            lay = arg(kernel)
            layout, width = cuda_qspa.launch_shape(plan, lay, design)
            got = ({"warps": width, "c_on_chip": cuda_qspa.c_on_chip(lay)}
                   if design == "warp" else {"groups": width})
            return got, cuda_qspa.blocks_per_sm(plan, lay, design, dev)
        G = module(kernel).groups(plan, arg(kernel), **extra(kernel))
        return {"groups": G}, module(kernel).blocks_per_sm(
            plan, arg(kernel), G, dev, **extra(kernel))

    point = {"code": code.name, "batch": batch, "max_passes": passes,
             "ebn0": ebn0}
    for kernel in calls:
        reader, row, _ = KERNELS[kernel]
        n = dict((fn, c) for _, fn, c in SOURCES)[reader]
        clocks = (ctypes.c_ulonglong * (n * len(PHASES)))()
        for design, call in calls[kernel].items():
            if design not in designs:
                continue
            ms = {}
            try:
                for which, use in (("plain", plain_lib), ("counted", lib)):
                    _build._lib = use
                    ms[which] = time_ms(call, dev, reps=3)
                getattr(lib, reader)(clocks)        # drop the timed calls
                _build._lib = lib
                call()
                torch.cuda.synchronize(dev)
            finally:
                _build._lib = plain_lib
            if getattr(lib, reader)(clocks):
                raise RuntimeError("reading the phase counters failed")
            mine = [clocks[row * len(PHASES) + i] for i in range(len(PHASES))]
            total = sum(mine)
            width, blocks = shape(kernel, design)
            yield {"kernel": kernel, **extra(kernel), "design": design,
                   **width, "blocks_per_sm": blocks, **point,
                   "ms": ms["plain"],
                   "ms_with_counters": ms["counted"],
                   "cycles_per_block": total / batch,
                   "share": {PHASES[i]: c / total for i, c in enumerate(mine)
                             if c}}
    saved = cuda_nbms.groups, cuda_qspa_stream.groups
    try:
        for G in groups:
            for mod in (cuda_nbms, cuda_qspa_stream):
                mod.groups = lambda plan, method, *_, G=G: G
            for kernel, call in calls.items():
                if module(kernel) is cuda_qspa or module(kernel).smem_bytes(
                        plan, G) > cuda_qspa.SMEM_LIMIT \
                        or 32 * plan.max_dc * G > (
                            1024 if G == 1 else cuda_qspa.GROUPED_THREADS):
                    continue
                width, blocks = shape(kernel, "groups")
                yield {"kernel": kernel, **extra(kernel), "design": "groups",
                       **width, "blocks_per_sm": blocks, **point,
                       "ms": time_ms(call["groups"], dev, reps=5)}
    finally:
        cuda_nbms.groups, cuda_qspa_stream.groups = saved
    k5 = [k for k in calls if "warp" in calls[k]]
    saved = cuda_qspa.warps
    try:
        for nw in warps:
            cuda_qspa.warps = lambda layered, nw=nw: nw
            for kernel in k5:
                if not 2 <= nw <= cuda_qspa.WARP_BOUNDS[arg(kernel)][0] // 32:
                    continue
                width, blocks = shape(kernel, "warp")
                yield {"kernel": kernel, "design": "warp", **width,
                       "blocks_per_sm": blocks, **point,
                       "ms": time_ms(calls[kernel]["warp"], dev, reps=5)}
    finally:
        cuda_qspa.warps = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "cuda_ldpc_torch.tools.nb_rows_phases")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--ebn0", type=float, default=0.0)
    ap.add_argument("--code", default="BDS.576.288.GF.64")
    ap.add_argument("--designs", default=",".join(DESIGNS))
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--groups", default="",
                    help="comma-separated numbers of row groups to time")
    ap.add_argument("--warps", default="",
                    help="comma-separated warps a block of K5's row on one "
                         "warp to time")
    ap.add_argument("--nm", type=int, default=16,
                    help="EMS's Nm for nbms_ems_nmnc")
    ap.add_argument("--nc", type=int, default=2,
                    help="EMS's Nc for nbms_ems_nmnc")
    args = ap.parse_args(argv)
    designs = tuple(args.designs.split(","))
    if not set(designs) <= set(DESIGNS):
        ap.error(f"--designs takes {','.join(DESIGNS)}")
    kernels = tuple(args.kernels.split(","))
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels takes {','.join(KERNELS)}")
    groups = tuple(int(g) for g in args.groups.split(",") if g)
    if any(not 1 <= g <= 7 for g in groups):
        ap.error("--groups takes numbers from 1 to 7")
    warps = tuple(int(w) for w in args.warps.split(",") if w)
    if any(not 2 <= w <= 32 for w in warps):
        ap.error("--warps takes numbers from 2 to 32")
    import torch
    if not torch.cuda.is_available():
        print("nb_rows_phases: needs a CUDA device", file=sys.stderr)
        return 1
    from cuda_ldpc_torch.utils.device import card_info
    card = card_info()
    for row in measure(args.batch, args.passes, args.ebn0, designs, groups,
                       warps, kernels, args.code, args.nm, args.nc):
        print(json.dumps({"card": card, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
