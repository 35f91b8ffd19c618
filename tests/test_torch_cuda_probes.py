"""The CUDA probes K9-K11 (cuda_ldpc_torch.tools.probe_bitops,
probe_mosaic, probe_oprate) against their plain PyTorch versions.
Tolerance: none, except probe_mosaic's dot3 and trans within 1e-6
relative (its TOLERANCE): the kernels do the plain versions' integer,
bitwise and fp32 operations in their order (__f*_rn, no fast math).

The kernel cases need a card and skip without one.  The file imports only
the port, so on a machine with a card and no JAX it runs on its own:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_probes.py
"""

import math

import pytest
import torch

from cuda_ldpc_torch.tools import probe_bitops, probe_mosaic, probe_oprate


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------- CPU side

def test_wrappers_take_the_plain_version_on_cpu():
    """A CPU tensor goes to the plain version, with no launch counted."""
    before = (dict(probe_bitops.LAUNCHES), dict(probe_mosaic.LAUNCHES),
              dict(probe_oprate.LAUNCHES))
    x9 = torch.from_numpy(probe_bitops.tile())
    for fn in probe_bitops.FUNCTIONS:
        assert torch.equal(probe_bitops.compute(fn, x9),
                           probe_bitops.plain(fn, x9))
    x10 = torch.from_numpy(probe_mosaic.tile())
    for fn in probe_mosaic.FUNCTIONS:
        e = probe_mosaic.extra_input(fn)
        e = None if e is None else torch.from_numpy(e)
        assert torch.equal(probe_mosaic.compute(fn, x10, e),
                           probe_mosaic.plain(fn, x10, e))
    x11 = torch.from_numpy(probe_oprate.tile())
    assert torch.equal(probe_oprate.chain("minsum_mix", x11, 4, 3),
                       probe_oprate.plain_chain("minsum_mix", x11, 4, 3))
    assert (dict(probe_bitops.LAUNCHES), dict(probe_mosaic.LAUNCHES),
            dict(probe_oprate.LAUNCHES)) == before
    # each probe's entry point runs on the CPU too, with the plain versions
    assert all(r["mismatches"] == 0 for r in probe_bitops.run("cpu"))
    assert all(r["mismatches"] == 0 for r in probe_mosaic.run("cpu"))
    assert len(probe_oprate.check("cpu")) == (len(probe_oprate.OPS) * 2
                                              * len(probe_oprate.CHECK_KS))


def test_what_the_wrappers_refuse():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="unknown function"):
        probe_bitops.compute("nope", x)
    with pytest.raises(ValueError, match="unsupported device"):
        probe_bitops.compute("signmag", x.to("meta"))
    x10 = torch.from_numpy(probe_mosaic.tile())
    with pytest.raises(ValueError, match="extra input"):
        probe_mosaic.compute("dot3", x10)
    with pytest.raises(ValueError, match="extra input"):
        probe_mosaic.compute("roll2", x10, torch.zeros(16, 16))
    with pytest.raises(ValueError, match="n_par"):
        probe_oprate.chain("add", x, 2, 1)
    with pytest.raises(ValueError, match="n_par"):
        probe_oprate.chain("add", x, 1, -1)
    with pytest.raises(ValueError, match="unknown op class"):
        probe_oprate.chain("mul", x, 1, 1)
    with pytest.raises(ValueError, match="even number of lanes"):
        probe_oprate.chain("add", torch.zeros(2, 15), 1, 1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        probe_oprate.measure("add", 1, "cpu")


@pytest.mark.parametrize("fn", sorted(probe_mosaic.TOLERANCE))
def test_mosaic_mismatch_counts_a_nan(fn):
    """A NaN is outside any tolerance: a kernel that writes one fails."""
    x = torch.from_numpy(probe_mosaic.tile())
    e = probe_mosaic.extra_input(fn)
    want = probe_mosaic.plain(fn, x, None if e is None else torch.from_numpy(e))
    got = want.clone()
    assert probe_mosaic.mismatch(fn, got, want) == 0
    got.view(-1)[[0, 5]] = torch.tensor([float("nan"), float("inf")])
    assert probe_mosaic.mismatch(fn, got, want) == 2


def test_oprate_held_compares_every_copy():
    """``held`` holds each copy of a grid against the plain chain."""
    x = torch.from_numpy(probe_oprate.tile())
    want = probe_oprate.plain_chain("minsum_mix", x, 1, 3)
    got = want.expand(3, *want.shape).clone()
    row = probe_oprate.held("minsum_mix", 1, 3, 3, got, want)
    assert (row["copies"], row["mismatches"]) == (3, 0)
    got[2, 7, 100] = -got[2, 7, 100]
    with pytest.raises(AssertionError, match="copies 3: 1 lanes differ"):
        probe_oprate.held("minsum_mix", 1, 3, 3, got, want)


@pytest.mark.parametrize("shift,n", [(1, 256), (3, 256), (37, 128), (17, 1280)])
def test_roll_is_jnp_roll(shift, n):
    """jnp.roll's direction, which every probe's roll (and the kernels'
    (j - shift) mod n) follows: out[j] = in[(j - shift) mod n]."""
    x = torch.arange(2 * n, dtype=torch.float32).reshape(2, n)
    got = torch.roll(x, shift, dims=1)
    for j in (0, 1, shift, n - 1):
        assert got[1, j] == x[1, (j - shift) % n]


def test_sass_check_reads_cuobjdump(tmp_path):
    """sass_counts parses `cuobjdump -sass` by chain kernel, and
    sass_unfolded flags a kernel whose class's instruction is missing from
    its unrolled steps.  cuobjdump is a stand-in script."""
    head = ("\t\tFunction : _ZN12oprate_probeL12chain_kernelINS_{}ELi{}EEEvPK"
            "fPfiiii\n")
    line = "        /*{:04x}*/            {} R0, R0, R1 ;   /* 0x0 */\n"
    body = {("5OpAdd", 1): ["FADD"] * 18, ("8OpBitxor", 1): ["LOP3.LUT"] * 6,
            ("5OpMix", 4): ["@!P0 LDS"] * 72 + ["BAR.SYNC"] * 18}
    text = "".join(head.format(k, n) + "".join(line.format(16 * i, op)
                                               for i, op in enumerate(ops))
                   for (k, n), ops in body.items())
    (tmp_path / "sass.txt").write_text(text)
    fake = tmp_path / "cuobjdump"
    fake.write_text(f"#!/bin/sh\ncat {tmp_path / 'sass.txt'}\n")
    fake.chmod(0o755)
    counts = probe_oprate.sass_counts(str(fake), "lib.so")
    assert counts[("add", 1)] == {"FADD": 18}
    assert counts[("minsum_mix", 4)] == {"LDS": 72, "BAR": 18}
    rows = {(r["op"], r["par"]): r["unfolded"]
            for r in probe_oprate.sass_unfolded(counts)}
    assert rows == {("add", 1): True, ("bitxor", 1): False,
                    ("minsum_mix", 4): True}


# --------------------------------------------------------------- card side

@pytest.mark.cuda
def test_probes_match_plain_on_card(cuda):
    """Every K9/K10 function and K11 chain, kernel against plain on the
    card (each run raises on a mismatch), each counting its launches."""
    for mod, key in ((probe_bitops, "probe_bitops"),
                     (probe_mosaic, "probe_mosaic")):
        before = mod.LAUNCHES[key]
        rows = mod.run(cuda)
        assert all(r["mismatches"] == 0 for r in rows)
        assert mod.LAUNCHES[key] - before == len(rows)
    rows = probe_oprate.check(cuda)       # and one full grid a chain kernel
    assert len(rows) == len(probe_oprate.OPS) * 2 * (
        len(probe_oprate.CHECK_KS) + 1)
    assert sum(r["copies"] > 1 for r in rows) == len(probe_oprate.OPS) * 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", probe_oprate.OPS)
def test_oprate_chain_on_card_over_copies(cuda, name):
    """Every copy of the tile in a grid gives the plain chain's result."""
    x = torch.from_numpy(probe_oprate.tile()).to(cuda)
    out = probe_oprate._launch(name, x, 4, 9, 3)
    want = probe_oprate.plain_chain(name, x, 4, 9)
    for c in range(3):
        assert torch.equal(out[c].view(torch.int32), want.view(torch.int32))
    assert probe_oprate.card_copies(name, 4, x.device) >= 1


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(cuda):
    with pytest.raises(ValueError, match="1 to 1024 lanes"):
        probe_bitops.compute("signmag", torch.zeros(2, 2048, device=cuda))
    with pytest.raises(ValueError, match="does not take"):
        probe_mosaic.compute("reduce0", torch.zeros(6, 2, 128, device=cuda))


@pytest.mark.cuda
def test_measure_gives_a_rate(cuda):
    row = probe_oprate.measure("add", 1, cuda, reps=1)
    assert row["tile_ms_hi"] > row["tile_ms_lo"] > 0
    assert math.isfinite(row["ops_per_s_per_sm"]) and row["card_copies"] >= 1
