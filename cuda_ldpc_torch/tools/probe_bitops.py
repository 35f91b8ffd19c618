"""The sign-bit algebra probe (K9): counterpart of cuda_ldpc_tpu's
tools/probe_bitops.py.

    python -m cuda_ldpc_torch.tools.probe_bitops [--device cuda]

The TPU probe asked whether Mosaic compiles the bit tricks of a sign-bit
min-sum check node (f32 <-> i32 bitcasts, i32 and/or/xor, an integer
minimum and compare on magnitudes, a roll of i32 lanes) and whether they
equal jnp.  Here each of its three functions is a CUDA kernel
(csrc/probe_bitops.cu) run on the probe's own tile, [8, 256] f32 drawn as
``numpy.random.default_rng(0).standard_normal * 3``, and held bit for bit
against its plain PyTorch version.  ``run`` raises on the first mismatch
(the TPU probe printed FAIL and went on).  Prints one JSON line a function.

``compute`` is the wrapper: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel, or the call raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from cuda_ldpc_torch.ops import _build
from cuda_ldpc_torch.utils.device import resolve_device

TB, Z = 8, 256
SIGN = -2**31                   # 0x80000000 as an int32
MAG = 0x7FFFFFFF
FUNCTIONS = ("signmag", "intcmp", "mixed")

# Calls that launched the kernel; read and reset by chip_smoke.py.
LAUNCHES = {"probe_bitops": 0}


def tile() -> np.ndarray:
    """The probe's input: [8, 256] f32, rng(0).standard_normal * 3."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((TB, Z)) * 3).astype(np.float32)


def _roll(t: torch.Tensor, shift: int) -> torch.Tensor:
    """jnp.roll along the rows: out[:, j] = t[:, (j - shift) mod cols]."""
    return torch.roll(t, shift, dims=1)


def plain(fn: str, x: torch.Tensor) -> torch.Tensor:
    """Function ``fn`` of the probe on x [rows, cols] f32, in PyTorch."""
    v = x.view(torch.int32)
    mag, sign = v & MAG, v & SIGN
    if fn == "signmag":
        m = torch.minimum(mag, _roll(mag, 1))
        return (m | (sign ^ _roll(sign, 1))).view(torch.float32)
    if fn == "intcmp":
        magr = _roll(mag, 3)
        return torch.where(magr < mag, torch.minimum(mag, magr),
                           mag).to(torch.float32)
    if fn == "mixed":
        magf = mag.view(torch.float32)
        m1 = torch.minimum(magf, _roll(magf, 1))
        return (m1.view(torch.int32) | sign).view(torch.float32)
    raise ValueError(f"unknown function {fn!r} (expected one of {FUNCTIONS})")


def compute(fn: str, x: torch.Tensor) -> torch.Tensor:
    """Function ``fn`` on x [rows, cols] f32 (cols <= 1024): the kernel on a
    CUDA tensor, the plain version on a CPU one."""
    if fn not in FUNCTIONS:
        raise ValueError(f"unknown function {fn!r} (expected one of "
                         f"{FUNCTIONS})")
    if x.device.type == "cpu":
        return plain(fn, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [rows, cols] float32 tensor")
    rows, cols = x.shape
    if not 1 <= cols <= 1024 or rows < 1:
        raise ValueError(f"the kernel takes 1 to 1024 lanes a row, got "
                         f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ldpc_probe_bitops(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()), rows,
        cols, FUNCTIONS.index(fn), x.device.index, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError("probe_bitops launch failed: "
                           + lib.ldpc_error_string(err).decode())
    LAUNCHES["probe_bitops"] += 1
    return out


def run(device: str | torch.device = "cuda") -> list[dict]:
    """Each function on the probe's tile against its plain version on the
    same device, bit for bit; raises AssertionError on a mismatch."""
    device = resolve_device(device)
    x = torch.from_numpy(tile()).to(device)
    rows = []
    for fn in FUNCTIONS:
        got, want = compute(fn, x), plain(fn, x)
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        rows.append({"probe": "bitops", "fn": fn, "shape": list(x.shape),
                     "device": str(device), "mismatches": bad,
                     "max_abs_err": float((got - want).abs().max())})
        if bad:
            raise AssertionError(f"probe_bitops {fn}: {bad} lanes differ "
                                 f"from the plain version")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cuda_ldpc_torch.tools.probe_bitops",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
