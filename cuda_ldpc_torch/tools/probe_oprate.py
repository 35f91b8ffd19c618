"""The op-rate probe (K11): counterpart of cuda_ldpc_tpu's
tools/probe_oprate.py.

    python -m cuda_ldpc_torch.tools.probe_oprate [--device cuda]

Sustained per-op-class rates on the card, on the tile the flooding
min-sum kernel's TPU version worked on ([8, 1280] f32, ``uniform(0.5,
1.5)`` from ``numpy.random.default_rng(0)``).  A chain kernel
(csrc/probe_oprate.cu) runs ``n_par`` independent chains of K dependent
steps of one op class: add, min, cmp_sel, sel, bitand, bitxor, roll (by 17)
or minsum_mix (the check node's per-edge mix), then sums the chains in
order.  ``measure`` takes the rate from the marginal time between K = 50,000
and 250,000 (CUDA events after a warm-up), for n_par 1 and 4:

* per SM, from the tile alone: a block per row, so 8 blocks on 8 SMs;
* per card, from a grid of independent copies of the tile that fills the
  card in one wave (as many whole copies as fit at once);
* and, for minsum_mix, the card's nanoseconds per edge-lane.

Rates count ``_ops_per_step`` operations a step, the TPU tool's own
count, so that the two tables read alike; ``FUNCTION_OPS`` counts the
operations a step needs, for the bound.  ``run`` first holds every chain
against its plain PyTorch version at two small K, bit for bit (on a card
also every copy of the full grid), and raises on a mismatch (the TPU
probe printed FAIL and went on).  Prints one JSON line a chain check and
one a rate.

``chain`` is the wrapper: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel, or the call raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from collections import Counter

import numpy as np
import torch

from cuda_ldpc_torch.ops import _build
from cuda_ldpc_torch.utils.device import resolve_device
from cuda_ldpc_torch.utils.timing import time_ms

TB, Z = 8, 1280
K_LO, K_HI = 50_000, 250_000
SIGN = -2**31                   # 0x80000000 as an int32
MAG = 0x7FFFFFFF
OPS = ("add", "min", "cmp_sel", "sel", "bitand", "bitxor", "roll",
       "minsum_mix")
N_PARS = (1, 4)
CHECK_KS = (1, 37)              # the chain lengths of the parity check
SHIFT = 17
UNROLL = 8                      # csrc/probe_oprate.cu's step loop

# The operations one step of each class needs, for the bound, counted as
# chip_smoke.nbms_bound_ms counts K8's: each add, subtract, multiply,
# minimum, compare, select or bitwise operation on a value is one, a
# bitcast nothing, and a roll nothing, since it moves lanes and does no
# arithmetic (a chain of rolls is one roll, bounded by the tile's bytes).
# minsum_mix: subtract, two masks, min(mag, x) once, compare, select, add,
# sign xor; the TPU builder computes the minimum twice.
FUNCTION_OPS = {"add": 1, "min": 3, "cmp_sel": 4, "sel": 4, "bitand": 2,
                "bitxor": 1, "roll": 0, "minsum_mix": 8}
# The SASS instructions that carry each class's step (the SASS check): a
# step issues one of them per lane and chain unless the compiler folded it.
SASS_OPS = {"add": ("FADD",), "min": ("FMNMX",), "cmp_sel": ("FSETP",),
            "sel": ("FSETP",), "bitand": ("LOP3", "FADD"),
            "bitxor": ("LOP3",), "roll": ("LDS",),
            "minsum_mix": ("LDS",)}

# Calls that launched the kernel; read and reset by chip_smoke.py.
LAUNCHES = {"probe_oprate": 0}

# The f32 constants of the steps, rounded to f32 once here
_F = {c: float(np.float32(c)) for c in (1.0000001, 1e-30, 3.4e38, 1.5,
                                          0.9999999, 1e-7, 0.001)}


def _ops_per_step(name: str) -> int:
    """The TPU tool's operations a step (probe_oprate.py:71-72)."""
    return {"add": 1, "min": 1, "cmp_sel": 2, "sel": 1, "bitand": 1,
            "bitxor": 1, "roll": 1, "minsum_mix": 9}[name]


def tile() -> np.ndarray:
    """The probe's input: [8, 1280] f32, rng(0).uniform(0.5, 1.5)."""
    return (np.random.default_rng(0).uniform(0.5, 1.5, (TB, Z))
            .astype(np.float32))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _float(v: torch.Tensor) -> torch.Tensor:
    return v.view(torch.float32)


def step(name: str, x: torch.Tensor) -> torch.Tensor:
    """One step of op class ``name`` on x [..., cols] f32, in PyTorch."""
    f = _F
    if name == "add":
        return x + f[1.0000001]
    if name == "min":
        return torch.clamp_max(x * f[1.0000001] + f[1e-30], f[3.4e38])
    if name == "cmp_sel":
        return torch.where(x < f[1.5], x + f[1.0000001], x * f[0.9999999])
    if name == "sel":
        return torch.where(x > 0, x + f[1e-7], x - f[1e-7])
    if name == "bitand":
        return _float(_bits(x) & MAG) + f[1e-7]
    if name == "bitxor":
        return _float(_bits(x) ^ SIGN)
    if name == "roll":
        return torch.roll(x, SHIFT, dims=-1)
    if name == "minsum_mix":
        w = _bits(torch.roll(x - f[0.001], SHIFT, dims=-1))
        mag, sgn = _float(w & MAG), w & SIGN
        m1 = torch.minimum(mag, x)
        m2 = torch.where(mag < x, x, m1)
        return _float(_bits(m2 + m1) ^ sgn)
    raise ValueError(f"unknown op class {name!r} (expected one of {OPS})")


def plain_chain(name: str, x: torch.Tensor, n_par: int,
                K: int) -> torch.Tensor:
    """The chain kernel's function in PyTorch: n_par chains x * (1 + 0.125
    i), K steps each, summed in order."""
    xs = [x * (1.0 + 0.125 * i) for i in range(n_par)]
    for _ in range(K):
        xs = [step(name, v) for v in xs]
    acc = xs[0]
    for v in xs[1:]:
        acc = acc + v
    return acc


def _check_shape(x: torch.Tensor, name: str, n_par: int, K: int):
    if name not in OPS:
        raise ValueError(f"unknown op class {name!r} (expected one of {OPS})")
    if n_par not in N_PARS or not 0 <= K < 2**31:
        raise ValueError(f"n_par must be one of {N_PARS} and 0 <= K < 2^31, "
                         f"got {n_par}, {K}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [rows, cols] float32 tensor")
    cols = x.shape[1]
    if cols % 2 or not SHIFT < cols <= 2048 or x.shape[0] < 1:
        raise ValueError(f"the kernel takes an even number of lanes from "
                         f"{SHIFT + 1} to 2048, got {tuple(x.shape)}")


def _launch(name: str, x: torch.Tensor, n_par: int, K: int,
            copies: int) -> torch.Tensor:
    rows, cols = x.shape
    out = torch.empty((copies, rows, cols), dtype=x.dtype, device=x.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ldpc_probe_oprate(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()), rows,
        cols, copies, OPS.index(name), n_par, K, x.device.index,
        ctypes.c_void_p(stream))
    if err:
        raise RuntimeError("probe_oprate launch failed: "
                           + lib.ldpc_error_string(err).decode())
    LAUNCHES["probe_oprate"] += 1
    return out


def chain(name: str, x: torch.Tensor, n_par: int, K: int) -> torch.Tensor:
    """n_par chains of K steps of ``name`` on x [rows, cols] f32, summed:
    the kernel on a CUDA tensor, the plain version on a CPU one."""
    _check_shape(x, name, n_par, K)
    if x.device.type == "cpu":
        return plain_chain(name, x, n_par, K)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(name, x, n_par, K, 1)[0]


def card_copies(name: str, n_par: int, device: torch.device) -> int:
    """Copies of the tile whose blocks all fit on the card at once, as many
    as fill it: rounded down, since a part copy past a full wave would add
    a second wave (a block per row, ``per_sm`` blocks an SM)."""
    lib = _build.load()
    per_sm = lib.ldpc_probe_oprate_blocks_per_sm(OPS.index(name), n_par, Z,
                                                 device.index)
    if per_sm < 1:
        raise RuntimeError(f"no block of the {name} chain fits on an SM")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, sms * per_sm // TB)


def measure(name: str, n_par: int, device: str | torch.device = "cuda",
            reps: int = 3) -> dict:
    """The rates of one op class with n_par chains, on the card: per SM
    from the tile, per card from a full grid of tile copies."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("measure times the card: it needs a CUDA device")
    x = torch.from_numpy(tile()).to(device)
    rows, cols = x.shape
    row = {"op": name, "par": n_par, "tile": [rows, cols], "k_lo": K_LO,
           "k_hi": K_HI, "ops_per_step": _ops_per_step(name)}
    for where, copies in (("tile", 1),
                          ("card", card_copies(name, n_par, device))):
        lo, hi = (time_ms(lambda k=k: _launch(name, x, n_par, k, copies),
                          device, reps) for k in (K_LO, K_HI))
        marg = (hi - lo) * 1e-3 / (K_HI - K_LO)      # seconds a step
        lanes = copies * rows * cols * n_par
        rate = lanes * _ops_per_step(name) / marg if marg > 0 else math.nan
        row.update({f"{where}_copies": copies, f"{where}_ms_lo": lo,
                    f"{where}_ms_hi": hi,
                    f"{where}_marginal_ns_per_step": marg * 1e9,
                    f"{where}_ops_per_s": rate})
        if where == "card" and name == "minsum_mix":
            row["ns_per_edge_lane"] = marg * 1e9 / lanes
    row["ops_per_s_per_sm"] = row["tile_ops_per_s"] / rows
    return row


def check(device: str | torch.device = "cuda") -> list[dict]:
    """Every chain (each class, n_par 1 and 4, K in CHECK_KS) against its
    plain version on the same device, bit for bit; on a card also every
    copy of the grid that ``measure`` launches for the card rate, at the
    last of CHECK_KS.  Raises AssertionError on a mismatch."""
    device = resolve_device(device)
    x = torch.from_numpy(tile()).to(device)
    rows = []
    for name in OPS:
        for n_par in N_PARS:
            for K in CHECK_KS:
                want = plain_chain(name, x, n_par, K)
                rows.append(held(name, n_par, K, 1, chain(name, x, n_par, K),
                                 want))
            if device.type == "cuda":
                copies = card_copies(name, n_par, device)
                rows.append(held(name, n_par, K, copies,
                                 _launch(name, x, n_par, K, copies), want))
    return rows


def held(name: str, n_par: int, K: int, copies: int, got: torch.Tensor,
         want: torch.Tensor) -> dict:
    """The check row of a kernel output ``got`` (one tile, or ``copies``
    of it) against the plain chain ``want``, bit for bit; raises
    AssertionError on a mismatch."""
    bad = int((_bits(got) != _bits(want)).sum())
    if bad:
        raise AssertionError(f"probe_oprate {name} n_par {n_par} K {K} "
                             f"copies {copies}: {bad} lanes differ from the "
                             f"plain version")
    return {"probe": "oprate", "op": name, "par": n_par, "K": K,
            "copies": copies, "device": str(got.device), "mismatches": bad}


def sass_counts(cuobjdump: str, library: str) -> dict[tuple[str, int], dict]:
    """Per chain kernel (op class, n_par): how many SASS instructions of
    each opcode the built library holds (``cuobjdump -sass``)."""
    out = subprocess.run([cuobjdump, "-sass", library], check=True,
                         capture_output=True, text=True, timeout=300).stdout
    structs = {"OpAdd": "add", "OpMin": "min", "OpCmpSel": "cmp_sel",
               "OpSel": "sel", "OpBitand": "bitand", "OpBitxor": "bitxor",
               "OpRoll": "roll", "OpMix": "minsum_mix"}
    counts: dict = {}
    for part in re.split(r"(?:^|\n)\s*Function : ", out)[1:]:
        name, body = part.split("\n", 1)
        m = re.search(r"chain_kernel\w*?(Op[A-Z][A-Za-z]*)ELi(\d)E", name)
        if not m or m.group(1) not in structs:
            continue
        ops = Counter(op.split(".")[0] for op in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body))
        counts[(structs[m.group(1)], int(m.group(2)))] = dict(ops)
    return counts


def sass_unfolded(counts: dict[tuple[str, int], dict]) -> list[dict]:
    """For each chain kernel, whether its class's instructions number at
    least one per lane, chain and step of the unrolled loop (2 lanes a
    thread, UNROLL steps): fewer means the compiler folded steps."""
    rows = []
    for (name, n_par), ops in sorted(counts.items()):
        issued = sum(ops.get(o, 0) for o in SASS_OPS[name])
        need = 2 * n_par * UNROLL
        rows.append({"op": name, "par": n_par, "sass_ops": SASS_OPS[name],
                     "issued": issued, "needed": need,
                     "unfolded": issued >= need})
    return rows


def run(device: str | torch.device = "cuda") -> list[dict]:
    """The parity check, then the rate of every class and n_par."""
    rows = check(device)
    rows += [measure(name, n_par, device) for name in OPS for n_par in N_PARS]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cuda_ldpc_torch.tools.probe_oprate",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
