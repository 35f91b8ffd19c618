"""Where the QC GF(q) QSPA kernel K6's time goes, phase by phase, on a card.

    python -m cuda_ldpc_torch.tools.qspa_qc_phases [--batch 256]
        [--passes 10] [--ebn0 3.0] [--designs global,staged]

It builds, into the git-ignored build directory, a copy of the kernels with
csrc/qspa_qc.cu compiled under ``QSPA_QC_PHASES``: thread 0 of every block
of K6 reads clock64() at the kernel's phase boundaries (``PHASE(n)``) and
adds the cycles since the previous one to a per-block counter, flushed to a
device counter per design and phase when the block ends.  One decode of at
most ``passes`` passes, early stop off, B = ``batch`` frames of
Tanner_74_9_Z128_GF16 at Eb/N0 ``ebn0`` dB (chip_smoke.py's timing point),
flooding and block-row layered, gives each phase's share of the summed
cycles, for the global design (``decode_*_global``, the earlier kernel) and
the new one (``decode_flooding``/``decode_layered``); the call's time with
the counters and without them (the library the package builds) is printed
beside it.  Thread 0's view: a phase's share holds that thread's own work,
and a barrier's the wait for the rest of the block.

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

# the Phase enum of csrc/qspa_qc.cu, in order
PHASES = ("setup", "vn", "vn_barrier", "decide", "decide_barrier",
          "syndrome", "gather", "spectra", "products", "output",
          "cn_barrier", "exit")
# design name -> (index in the counters, wrapper suffix)
DESIGNS = {"global": (0, "_global"), "staged": (1, "")}


def phase_names(src: str) -> tuple:
    """The Phase enum's names in csrc/qspa_qc.cu's text, lower case without
    the ``kPh`` prefix and without kPhCount."""
    body = re.search(r"enum Phase \{(.*?)\};", src, re.S)
    if body is None:
        raise ValueError("no Phase enum in qspa_qc.cu")
    names = re.findall(r"kPh(\w+)", body.group(1))
    snake = [re.sub(r"(?<!^)([A-Z])", r"_\1", n).lower() for n in names]
    return tuple(n for n in snake if n != "count")


def patched_source(src: str) -> str:
    """csrc/qspa_qc.cu with the phase counters compiled in; raises
    ValueError when its Phase enum is not the one this tool reads."""
    if phase_names(src) != PHASES:
        raise ValueError(f"qspa_qc.cu's phases {phase_names(src)} are not "
                         f"{PHASES}")
    return "#define QSPA_QC_PHASES 1\n" + src


def _instrumented_lib(root: pathlib.Path):
    """The package's library built from the patched sources under root."""
    from cuda_ldpc_torch.ops import _build
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, csrc)
    (csrc / "qspa_qc.cu").write_text(
        patched_source((csrc / "qspa_qc.cu").read_text()))
    saved = _build.CSRC_DIR, _build.BUILD_DIR
    try:
        _build.CSRC_DIR, _build.BUILD_DIR = csrc, root / "build"
        lib = _build._bind(ctypes.CDLL(str(_build.build())))
    finally:
        _build.CSRC_DIR, _build.BUILD_DIR = saved
    lib.ldpc_qspa_qc_phase_clocks.argtypes = [ctypes.c_void_p]
    lib.ldpc_qspa_qc_phase_clocks.restype = ctypes.c_int
    return lib


def measure(batch: int = 256, passes: int = 10, ebn0: float = 3.0,
            designs=tuple(DESIGNS)):
    """Yield one dict per design and schedule (see the module docstring)."""
    import numpy as np
    import torch

    from cuda_ldpc_torch.models.nb_code import NBCode
    from cuda_ldpc_torch.ops import _build, channel, cuda_qspa_qc, demod
    from cuda_ldpc_torch.utils.constellations import constellation
    from cuda_ldpc_torch.utils.timing import time_ms

    dev = torch.device("cuda", 0)
    root = _build.BUILD_DIR / "qspa_qc_phases"
    root.mkdir(parents=True, exist_ok=True)
    plain_lib = _build.load()
    lib = _instrumented_lib(root)
    clocks = (ctypes.c_ulonglong * (2 * len(PHASES)))()
    code = NBCode.from_registry("Tanner_74_9_Z128_GF16")
    sigma = channel.sigma_from_snr(ebn0, code.rate, "ebn0", 1.0)
    g = torch.Generator(device=dev).manual_seed(17)
    L = demod.nb_channel_llr(g, np.zeros(code.bit_length, dtype=np.int64),
                             constellation(2), sigma, batch, code.q,
                             device=dev)
    for design in designs:
        index, suffix = DESIGNS[design]
        for schedule in ("flooding", "layered"):
            decode = getattr(cuda_qspa_qc, f"decode_{schedule}{suffix}")

            def call():
                return decode(L, code, passes, early_stop=False)

            ms = {}
            try:
                for which, use in (("plain", plain_lib), ("counted", lib)):
                    _build._lib = use
                    ms[which] = time_ms(call, dev, reps=3)
                lib.ldpc_qspa_qc_phase_clocks(clocks)   # drop the timed calls
                _build._lib = lib
                res = call()
                torch.cuda.synchronize(dev)
            finally:
                _build._lib = plain_lib
            if lib.ldpc_qspa_qc_phase_clocks(clocks):
                raise RuntimeError("reading the phase counters failed")
            mine = [clocks[index * len(PHASES) + i]
                    for i in range(len(PHASES))]
            total = sum(mine)
            iters = res.iters.tolist()
            yield {"design": design, "schedule": schedule,
                   "code": code.name, "batch": batch, "max_passes": passes,
                   "ebn0": ebn0,
                   "frame_passes": sum(min(i + 1, passes) for i in iters),
                   "ms": ms["plain"], "ms_with_counters": ms["counted"],
                   "cycles_per_block": total / batch,
                   "share": {PHASES[i]: c / total for i, c in enumerate(mine)
                             if c}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "cuda_ldpc_torch.tools.qspa_qc_phases")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--ebn0", type=float, default=3.0)
    ap.add_argument("--designs", default=",".join(DESIGNS))
    args = ap.parse_args(argv)
    designs = tuple(args.designs.split(","))
    if not set(designs) <= set(DESIGNS):
        ap.error(f"--designs takes {','.join(DESIGNS)}")
    import torch
    if not torch.cuda.is_available():
        print("qspa_qc_phases: needs a CUDA device", file=sys.stderr)
        return 1
    from cuda_ldpc_torch.utils.device import card_info
    card = card_info()
    for row in measure(args.batch, args.passes, args.ebn0, designs):
        print(json.dumps({"card": card, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
