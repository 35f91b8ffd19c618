"""The tile-operation probe (K10): counterpart of cuda_ldpc_tpu's
tools/probe_mosaic.py.

    python -m cuda_ldpc_torch.tools.probe_mosaic [--device cuda]

The TPU probe asked which of the ops the QC GF(q) QSPA kernel was designed
from Mosaic compiles: leading-axis slices and concatenation, a dim-0 iota,
a rank-3 dot_general over the leading axis, minor-most rolls, leading-axis
reductions, exp/log under a broadcast mask, lane masks and row stacks.
Here each of its nine functions is a CUDA kernel (csrc/probe_mosaic.cu) run
on the probe's own input, x = arange(16 * 2 * 128) / 97 as [Q=16, TB=2,
Z=128] f32 (with its m [16, 16] for dot3 and its lane mask [1, 1, 128] for
lanemask), and held against its plain PyTorch version: exactly, except
``dot3`` and ``trans`` within ``TOLERANCE`` (relative; another summation
order or math library moves the last bits).  ``run`` raises on the first
mismatch (the TPU probe printed FAIL and went on).

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

Q, TB, Z = 16, 2, 128
FUNCTIONS = ("slice_concat", "iota0", "dot3", "roll2", "reduce0",
             "reduce0_native", "trans", "lanemask", "rowstack")
# Relative tolerance of the two functions whose float result depends on the
# order of a sum (dot3) or on the exp/log implementation (trans).
TOLERANCE = {"dot3": 1e-6, "trans": 1e-6}

# Calls that launched the kernel; read and reset by chip_smoke.py.
LAUNCHES = {"probe_mosaic": 0}


def tile() -> np.ndarray:
    """The probe's input x: arange(Q * TB * Z) / 97 as [Q, TB, Z] f32."""
    return np.arange(Q * TB * Z, dtype=np.float32).reshape(Q, TB, Z) / 97.0


def extra_input(fn: str) -> np.ndarray | None:
    """The probe's second input: m [Q, Q] (+1 where (u & k) is even, else
    -1) for dot3, the lane mask [1, 1, Z] (z mod 2) for lanemask."""
    if fn == "dot3":
        return np.where((np.arange(Q)[:, None] & np.arange(Q)[None, :]) % 2
                        == 0, 1.0, -1.0).astype(np.float32)
    if fn == "lanemask":
        return (np.arange(Z) % 2).astype(np.float32).reshape(1, 1, Z)
    return None


def plain(fn: str, x: torch.Tensor,
          extra: torch.Tensor | None = None) -> torch.Tensor:
    """Function ``fn`` of the probe on x [Q, TB, Z] f32, in PyTorch."""
    q, h = x.shape[0], x.shape[0] // 2
    if fn == "slice_concat":
        return torch.cat([x[0:1], x[h:q], x[1:h]], dim=0)
    if fn == "iota0":
        rows = torch.arange(q, device=x.device).reshape(-1, 1, 1)
        return torch.where((rows & 4) != 0, -x, x)
    if fn == "dot3":
        # k ascending from 0, one rounding a product and a sum
        acc = torch.zeros_like(x)
        for k in range(q):
            acc = acc + extra[:, k].reshape(-1, 1, 1) * x[k]
        return acc
    if fn == "roll2":
        return torch.roll(x, 37, dims=2)
    if fn == "reduce0":
        m = x
        while m.shape[0] > 1:
            w = m.shape[0] // 2
            m = torch.maximum(m[:w], m[w:2 * w])
        return x - m
    if fn == "reduce0_native":
        return x - x.amax(dim=0, keepdim=True)
    if fn == "trans":
        cont = x[0:1, :, 0:1] > 0.5
        return torch.where(cont, torch.log(torch.exp(x) + 1.0), x)
    if fn == "lanemask":
        return torch.where(extra != 0.0, -x, x)
    if fn == "rowstack":
        return torch.stack([x[0] + (-1.0) ** i * x[i % h] for i in range(q)])
    raise ValueError(f"unknown function {fn!r} (expected one of {FUNCTIONS})")


def compute(fn: str, x: torch.Tensor,
            extra: torch.Tensor | None = None) -> torch.Tensor:
    """Function ``fn`` on x [Q, TB, Z] f32 (Q even, a power of two for
    reduce0; Z <= 1024) with its ``extra`` input: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    if fn not in FUNCTIONS:
        raise ValueError(f"unknown function {fn!r} (expected one of "
                         f"{FUNCTIONS})")
    if x.dim() != 3:
        raise ValueError(f"x must be [Q, TB, Z], got {tuple(x.shape)}")
    q, tb, z = x.shape
    want_extra = {"dot3": (q, q), "lanemask": (1, 1, z)}.get(fn)
    if (extra is None) != (want_extra is None) or (
            extra is not None and tuple(extra.shape) != want_extra):
        raise ValueError(f"{fn} takes an extra input of shape {want_extra}, "
                         f"got {None if extra is None else tuple(extra.shape)}")
    if x.device.type == "cpu":
        return plain(fn, x, extra)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for t in (x, extra):
        if t is not None and (t.dtype != torch.float32 or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError("inputs must be contiguous float32 tensors on "
                             "one device")
    if (q < 2 or q % 2 or not 1 <= z <= 1024 or tb < 1
            or 2 * q * z * 4 > 48 * 1024
            or (fn == "reduce0" and q & (q - 1))):
        raise ValueError(f"the kernel does not take the shape "
                         f"{tuple(x.shape)} for {fn}")
    out = torch.empty_like(x)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ldpc_probe_mosaic(
        ctypes.c_void_p(x.data_ptr()),
        ctypes.c_void_p(extra.data_ptr() if extra is not None else 0),
        ctypes.c_void_p(out.data_ptr()), q, tb, z, FUNCTIONS.index(fn),
        x.device.index, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError("probe_mosaic launch failed: "
                           + lib.ldpc_error_string(err).decode())
    LAUNCHES["probe_mosaic"] += 1
    return out


def mismatch(fn: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Lanes where ``got`` is not ``want``: bit for bit, or not within the
    function's relative tolerance (a NaN is never within it)."""
    if fn in TOLERANCE:
        tol = TOLERANCE[fn] * want.abs()
        return int((~((got - want).abs() <= tol)).sum())
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def run(device: str | torch.device = "cuda") -> list[dict]:
    """Each function on the probe's inputs against its plain version on the
    same device; raises AssertionError on a mismatch."""
    device = resolve_device(device)
    x = torch.from_numpy(tile()).to(device)
    rows = []
    for fn in FUNCTIONS:
        e = extra_input(fn)
        extra = None if e is None else torch.from_numpy(e).to(device)
        got, want = compute(fn, x, extra), plain(fn, x, extra)
        bad = mismatch(fn, got, want)
        rows.append({"probe": "mosaic", "fn": fn, "shape": list(x.shape),
                     "device": str(device), "mismatches": bad,
                     "tolerance": TOLERANCE.get(fn, 0.0),
                     "max_abs_err": float((got - want).abs().max())})
        if bad:
            raise AssertionError(f"probe_mosaic {fn}: {bad} lanes differ "
                                 f"from the plain version")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cuda_ldpc_torch.tools.probe_mosaic",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
