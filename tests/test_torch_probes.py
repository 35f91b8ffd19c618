"""The probes K9-K11 of the port (cuda_ldpc_torch.tools.probe_bitops,
probe_mosaic, probe_oprate) against the JAX package's tools/probe_*.py.

Each TPU kernel of a JAX probe runs on the CPU as ``pl.pallas_call(kernel,
..., interpret=True)``: for K9 and K10 the probe's own ``main`` runs with
its ``run`` replaced by that call, so that the probe builds its kernels and
inputs itself; for K11 ``_chain(_builder(name), n_par, K)`` runs at K = 1
and 7 for every op class and n_par 1 and 4.  The port's plain PyTorch
versions (what the CUDA kernels are held to on the card) take the same
numpy inputs.  Tolerance: bit for bit, except probe_mosaic's dot3 (a sum
of 16 products) and trans (exp and log) within 1e-6 relative, since XLA's
dot and math library may order or round differently, and K11 with four
chains at K = 1 within the same 1e-6: there XLA folds the one-trip loop
and contracts the chains' initial products x * (1 + 0.125 i) into the
first step and the final sum as fused multiply-adds (at K = 0 its output
is exactly fma(x, 1.375, fma(x, 1.25, fma(x, 1.125, x)))), while the port,
like XLA itself at K >= 2, rounds each product and sum.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cuda_ldpc_torch.tools import probe_bitops, probe_mosaic, probe_oprate

REPO = pathlib.Path(__file__).resolve().parents[1]

BITOPS_NAMES = {"signmag": "signmag_min_xor_or", "intcmp": "intcmp_where",
                "mixed": "mixed_f32min_bitsign"}
MOSAIC_NAMES = {"slice_concat": "slice_concat", "iota0": "iota_dim0",
                "dot3": "dot_general_rank3", "roll2": "roll_axis2",
                "reduce0": "reduce0_slices",
                "reduce0_native": "reduce0_native",
                "trans": "transcendental_where",
                "lanemask": "lane_mask_bcast", "rowstack": "row_stack"}


def _jax_probe(name):
    """A private copy of the JAX package's tools/<name>.py (the directory
    is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(kernel, shape, *ins):
    out = pl.pallas_call(kernel,
                         out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                         interpret=True)(*ins)
    return np.asarray(out)


@pytest.fixture(scope="module")
def jax_bitops():
    """name -> (input, interpret-mode output, the probe's numpy reference)."""
    mod, got = _jax_probe("probe_bitops"), {}

    def run(name, kernel, x, ref):
        got[name] = (x, _interpret(kernel, x.shape, x), ref)

    mod.run = run
    mod.main()
    return got


@pytest.fixture(scope="module")
def jax_mosaic():
    """name -> (inputs, interpret-mode output)."""
    mod, got = _jax_probe("probe_mosaic"), {}
    x = np.arange(mod.Q * mod.TB * mod.Z, dtype=np.float32).reshape(
        mod.Q, mod.TB, mod.Z) / 97.0

    def run(name, kernel, extra_in=None):
        ins = [x] if extra_in is None else [x, extra_in]
        got[name] = (ins, _interpret(kernel, x.shape, *ins))
        return got[name][1]

    mod.run = run
    mod.main()
    return got


@pytest.fixture(scope="module")
def jax_oprate():
    return _jax_probe("probe_oprate")


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("fn", probe_bitops.FUNCTIONS)
def test_bitops_equals_jax_interpret(jax_bitops, fn):
    x, want, ref = jax_bitops[BITOPS_NAMES[fn]]
    np.testing.assert_array_equal(probe_bitops.tile(), x)
    got = probe_bitops.plain(fn, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("fn", probe_mosaic.FUNCTIONS)
def test_mosaic_equals_jax_interpret(jax_mosaic, fn):
    ins, want = jax_mosaic[MOSAIC_NAMES[fn]]
    np.testing.assert_array_equal(probe_mosaic.tile(), ins[0])
    extra = probe_mosaic.extra_input(fn)
    if len(ins) > 1:
        np.testing.assert_array_equal(extra, ins[1])
    else:
        assert extra is None
    got = probe_mosaic.plain(fn, torch.from_numpy(ins[0]),
                             None if extra is None else torch.from_numpy(extra))
    bad = probe_mosaic.mismatch(fn, got, torch.from_numpy(want.copy()))
    assert bad == 0, f"{fn}: {bad} lanes differ"


@pytest.mark.parametrize("K", [1, 7])
@pytest.mark.parametrize("n_par", probe_oprate.N_PARS)
@pytest.mark.parametrize("name", probe_oprate.OPS)
def test_oprate_chain_equals_jax_interpret(jax_oprate, name, n_par, K):
    x = (np.random.default_rng(0).uniform(0.5, 1.5, (jax_oprate.TB,
                                                      jax_oprate.Z))
         .astype(np.float32))
    np.testing.assert_array_equal(probe_oprate.tile(), x)
    want = _interpret(jax_oprate._chain(jax_oprate._builder(name), n_par, K),
                      x.shape, x)
    got = probe_oprate.chain(name, torch.from_numpy(x), n_par, K).numpy()
    if n_par > 1 and K == 1:       # XLA's contraction (module docstring)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_oprate_constants_match_jax(jax_oprate):
    """The port keeps its own copies of the probe's constants."""
    assert (probe_oprate.TB, probe_oprate.Z) == (jax_oprate.TB, jax_oprate.Z)
    assert (probe_oprate.K_LO, probe_oprate.K_HI) == (jax_oprate.K_LO,
                                                      jax_oprate.K_HI)
    assert (probe_oprate.SIGN, probe_oprate.MAG) == (int(jax_oprate.SIGN),
                                                     int(jax_oprate.MAG))
    for name in probe_oprate.OPS:
        assert (probe_oprate._ops_per_step(name)
                == jax_oprate._ops_per_step(name))
    mosaic = _jax_probe("probe_mosaic")
    bitops = _jax_probe("probe_bitops")
    assert (probe_mosaic.Q, probe_mosaic.TB, probe_mosaic.Z) == (
        mosaic.Q, mosaic.TB, mosaic.Z)
    assert (probe_bitops.TB, probe_bitops.Z, probe_bitops.SIGN,
            probe_bitops.MAG) == (bitops.TB, bitops.Z, int(bitops.SIGN),
                                  int(bitops.MAG))
