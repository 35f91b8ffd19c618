"""The tile-operation probe (K10): counterpart of cuda_ldpc_tpu's
tools/probe_mosaic.py.

    python -m cuda_ldpc_torch.tools.probe_mosaic [--device cuda] [--timing]

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
tensor to the kernel, or the call raises.  It checks a shape once: a later
call of the same function and shapes on the same device checks dtype and
contiguity and launches.  ``--timing`` (a card only) prints ``timing``'s
line: roll2 against ``torch.roll``, host and device time a call.
"""

from __future__ import annotations

import argparse
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


# fn -> its launcher once a call's checks have passed (see _launcher)
_FAST: dict[str, object] = {}

# outputs allocated at once, as slices of one tensor, by a launcher: few
# enough that every timed window of 20 calls pays its share of the refills
OUT_SLAB = 16


def compute(fn: str, x: torch.Tensor,
            extra: torch.Tensor | None = None) -> torch.Tensor:
    """Function ``fn`` on x [Q, TB, Z] f32 (Q even, a power of two for
    reduce0; Z <= 1024) with its ``extra`` input: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    fast = _FAST.get(fn)
    if fast is not None:
        out = fast(x, extra)
        if out is not None:
            return out
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
    fast = _FAST[fn] = _launcher(fn, x, extra)
    return fast(x, extra)


def _launcher(fn: str, x: torch.Tensor, extra: torch.Tensor | None):
    """``go(x, extra)`` for inputs whose shapes, dtype, contiguity and
    device are those of ``x`` and ``extra``, checked once: one launch of
    ``fn`` on the current stream of x's device, or None for other inputs
    (``compute`` then checks them in full).  Its outputs are fresh,
    contiguous and disjoint: slices of a tensor of OUT_SLAB of them,
    allocated when the last one has been handed out (a Python-level
    torch.empty_like a call costs about twice a slice's share)."""
    lib = _build.load()
    current_stream = torch._C._cuda_getCurrentRawStream
    shape, device = x.shape, x.get_device()
    q, tb, z = shape
    extra_shape = None if extra is None else extra.shape
    f32 = torch.float32
    free: list = []

    def refill():
        free.extend(torch.empty((OUT_SLAB, q, tb, z),
                                device=torch.device("cuda", device))
                    .unbind(0))
        return free.pop()

    def failed(err):
        return RuntimeError("probe_mosaic launch failed: "
                            + lib.ldpc_error_string(err).decode())

    if fn == "roll2" and z % 4 == 0:
        roll2, rows = lib.ldpc_probe_mosaic_roll2, q * tb

        def go(x, extra):
            if not (extra is None and x.shape == shape
                    and x.get_device() == device and x.dtype is f32
                    and x.is_contiguous()):
                return None
            out = free.pop() if free else refill()
            err = roll2(x.data_ptr(), out.data_ptr(), rows, z, device,
                        current_stream(device))
            if err:
                raise failed(err)
            LAUNCHES["probe_mosaic"] += 1
            return out
        return go

    mosaic, index = lib.ldpc_probe_mosaic, FUNCTIONS.index(fn)

    def go(x, extra):
        if not (x.shape == shape and x.get_device() == device
                and x.dtype is f32 and x.is_contiguous()
                and (extra is None if extra_shape is None else (
                    extra is not None and extra.shape == extra_shape
                    and extra.get_device() == device
                    and extra.dtype is f32 and extra.is_contiguous()))):
            return None
        out = free.pop() if free else refill()
        err = mosaic(x.data_ptr(), None if extra is None else
                     extra.data_ptr(), out.data_ptr(), q, tb, z, index,
                     device, current_stream(device))
        if err:
            raise failed(err)
        LAUNCHES["probe_mosaic"] += 1
        return out
    return go


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


def timing(reps: int = 20) -> dict:
    """roll2 on the probe's tile against ``torch.roll(x, 37, dims=2)``, the
    PyTorch call that computes it, on CUDA device 0: each one's time a call
    (``utils.timing.time_ms``: CUDA events around ``reps`` back-to-back
    calls, so the host's part of a call counts), its device time a call
    (torch.profiler: the CUDA kernels' time over ``reps`` calls), and the
    lanes where the two outputs differ.  Run it in a fresh process: one that
    has run many kernels between a few traces may record no kernel events
    (PERF.md section 7)."""
    from cuda_ldpc_torch.utils.timing import profiler_activities, time_ms
    dev = torch.device("cuda", 0)
    x = torch.from_numpy(tile()).to(dev)
    calls = {"kernel": lambda: compute("roll2", x),
             "library": lambda: torch.roll(x, 37, dims=2)}
    out = {"fn": "roll2", "shape": list(x.shape), "reps": reps}
    for call in calls.values():             # warm both call paths up
        for _ in range(reps):
            call()
    torch.cuda.synchronize(dev)
    for key, call in calls.items():
        out["ms" if key == "kernel" else "library_ms"] = time_ms(call, dev,
                                                                 reps)
    for key, call in calls.items():
        with torch.profiler.profile(
                activities=profiler_activities(dev)) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize(dev)
        device_us = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.self_device_time_total > 0)
        out["device_ms" if key == "kernel" else "library_device_ms"] = (
            device_us / 1e3 / reps if device_us else None)
    out["mismatches"] = mismatch("roll2", calls["kernel"](),
                                 calls["library"]())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cuda_ldpc_torch.tools.probe_mosaic",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timing", action="store_true",
                    help="roll2 against torch.roll on CUDA device 0")
    args = ap.parse_args(argv)
    if args.timing:
        if not torch.cuda.is_available():
            print("probe_mosaic --timing: needs a CUDA device",
                  file=sys.stderr)
            return 1
        from cuda_ldpc_torch.utils.device import card_info
        print(json.dumps({"card": card_info(), **timing()}), flush=True)
        return 0
    for row in run(args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
