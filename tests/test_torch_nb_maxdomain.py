"""The port's plain max-domain GF(q) decoders (cuda_ldpc_torch.ops.nb_decode:
EMS for several (Nm, Nc), full EMS, flooding, layered and grouped-layered
TMM) against the JAX package's ``nb_decode`` and the loop oracle
tests/oracle_nb.py, on the same numpy inputs, on the CPU.

Tolerance: none.  Hard, ok and iters agree exactly, and so do the decoder
states after a pass and single CN updates: every step is a gather, a max or
min, or one rounding in the JAX package's order (nb_decode's docstring).
The JAX decoders run jnp (the Pallas kernel K8 is held to them by
tests/test_pallas_nbms.py); a JAX call costs 0.3-5 s here, mostly its
compile, so the cases are few and small.  The whole decodes of the registry
codes are in tests/test_torch_nb_maxdomain_codes.py.
"""

import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu.ops import nb_decode as jax_nb
from cuda_ldpc_torch.ops import nb_decode

from test_nb_decode import noisy_zero_llr, run_oracle, synthetic_code
from test_torch_nb_decode import codes
from test_torch_nb_host import port_code


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_SYNTH = {}


def synth(dc):
    """(port code, JAX code): the dc=4 and dc=6 synthetic GF(8) codes of
    tests/test_nb_decode.py."""
    if dc not in _SYNTH:
        theirs = (synthetic_code() if dc == 4 else
                  synthetic_code(q=8, N=12, M=4, dv=2, dc=6, seed=5))
        _SYNTH[dc] = (port_code(theirs), theirs)
    return _SYNTH[dc]


def assert_same(ours, theirs):
    assert ours.hard.dtype == torch.int32 and ours.iters.dtype == torch.int32
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def both(code, jax_code, L, method, iters, **kw):
    ours = nb_decode.decode(torch.from_numpy(L), code, method, iters, **kw)
    assert_same(ours, jax_nb.decode(jnp.asarray(L), jax_code, method, iters,
                                    **kw))
    return ours


SYNTH_CASES = [
    # method, (nm, nc), oracle
    ("ems", (2, 2), True), ("ems", (3, 2), True), ("ems", (2, 1), True),
    ("ems", (2, 3), True),          # the reference's Nc == maxdc-1 sentinel
    ("ems", (3, 3), True), ("ems_full", (2, 2), True), ("tmm", (2, 2), True),
    ("layered_tmm", (2, 2), True), ("glayered_tmm", (2, 2), False),
]


@pytest.mark.parametrize("method,nmnc,oracle", SYNTH_CASES,
                         ids=[f"{c[0]}-{c[1][0]}{c[1][1]}" for c in SYNTH_CASES])
def test_synthetic_code_matches_jax_and_oracle(method, nmnc, oracle):
    code, jax_code = synth(4)
    L = noisy_zero_llr(code, np.random.default_rng(42), batch=8)
    nm, nc = nmnc
    ours = both(code, jax_code, L, method, 6, nm=nm, nc=nc)
    if oracle:
        hard, ok, iters = run_oracle(code, L, method, 6, nm=nm, nc=nc)
        np.testing.assert_array_equal(ours.ok.numpy(), ok)
        np.testing.assert_array_equal(ours.iters.numpy(), iters)
        np.testing.assert_array_equal(ours.hard.numpy(), hard)


@pytest.mark.parametrize("nm,nc", [(3, 3), (2, 4), (4, 3)])
def test_budgeted_dp_matches_jax_and_oracle(nm, nc):
    """2 < Nc < dc-1 on the dc=6 code: the budgeted (max,+) DP branch."""
    code, jax_code = synth(6)
    L = noisy_zero_llr(code, np.random.default_rng(11), batch=4)
    ours = both(code, jax_code, L, "ems", 4, nm=nm, nc=nc)
    hard, ok, iters = run_oracle(code, L, "ems", 4, nm=nm, nc=nc)
    np.testing.assert_array_equal(ours.hard.numpy(), hard)
    np.testing.assert_array_equal(ours.ok.numpy(), ok)
    np.testing.assert_array_equal(ours.iters.numpy(), iters)


@pytest.mark.parametrize("core", ["ems", "ems_full", "tmm"])
def test_cn_cores_match_jax(core):
    """One CN update of every row of LDPC_N576_K288_GF64_d1_exp (its
    coefficient-0 edges included), on messages with ties."""
    code, jax_code = codes("LDPC_N576_K288_GF64_d1_exp")
    g, jg = nb_decode.build_graph(code), jax_nb.build_graph(jax_code)
    rng = np.random.default_rng(8)
    v2c = np.round(rng.normal(size=(2, g.M, g.dc, g.q)) * 4) / 4
    v2c = v2c.astype(np.float32)
    v2c[..., 0] = 0.0
    args = (torch.from_numpy(v2c), torch.as_tensor(g.cn_mask),
            torch.as_tensor(g.h_perm))
    jargs = (jnp.asarray(v2c), jnp.asarray(jg.cn_mask))
    onehot = jnp.asarray(jg.h_onehot, dtype=jnp.float32)
    if core == "ems":
        ours = nb_decode._ems_cn_core(*args, 2, 2, g.dc, g.q)
        theirs = jax_nb._ems_cn_core(*jargs, onehot, 2, 2, g.dc, g.q)
    elif core == "ems_full":
        ours = nb_decode._ems_full_cn_core(*args, g.dc, g.q)
        theirs = jax_nb._ems_full_cn_core(*jargs, onehot,
                                          jnp.asarray(jg.xor_table),
                                          g.dc, g.q)
    else:
        ours = nb_decode._tmm_cn_core(*args, g.dc, g.q)
        theirs = jax_nb._tmm_cn_core(*jargs, jnp.asarray(jg.h_perm), onehot,
                                     g.dc, g.q)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_helpers_match_jax():
    """The XOR shifts, the min-domain conversion and the top-(Nm-1)
    selection with ties (jax.lax.top_k's index order)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 4, 16)).astype(np.float32)
    s = rng.integers(0, 16, size=(3, 4))
    np.testing.assert_array_equal(
        nb_decode._xor_shift(torch.from_numpy(x), torch.from_numpy(s)),
        jax_nb._xor_shift(jnp.asarray(x), jnp.asarray(s, dtype=jnp.int32)))
    for j in (0, 5, 15):
        np.testing.assert_array_equal(
            nb_decode._xor_shift_const(torch.from_numpy(x), j),
            jax_nb._xor_shift_const(jnp.asarray(x), j))
    np.testing.assert_array_equal(
        nb_decode.to_min_domain(torch.from_numpy(x)),
        jax_nb.to_min_domain(jnp.asarray(x)))
    ties = np.round(x * 2) / 2
    ties[0, 0] = nb_decode.NEG                  # a row of equal values
    for k in (1, 2, 3):
        vals, idx = nb_decode._top_first(torch.from_numpy(ties), k)
        jv, ji = jax.lax.top_k(jnp.asarray(ties), k)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_fma_f32_rounds_once():
    """``_fma_f32`` against exact rational arithmetic: the float32 nearest
    to a*b + c, ties to even, on random and on near-tie operands."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=4000).astype(np.float32) * 8
    c = (rng.normal(size=4000) * np.exp2(rng.integers(-30, 30, 4000)))
    c = c.astype(np.float32)
    b = nb_decode.TMM_SCALE
    # near ties: c = -(a*b) rounded, so a*b + c is the product's tail
    c[:1000] = -(a[:1000].astype(np.float64) * b).astype(np.float32)
    got = nb_decode._fma_f32(torch.from_numpy(a), b, torch.from_numpy(c))
    for ai, ci, r in zip(a.tolist(), c.tolist(), got.numpy()):
        exact = fractions.Fraction(ai) * fractions.Fraction(b) + \
            fractions.Fraction(ci)
        lo = np.nextafter(r, np.float32(-np.inf), dtype=np.float32)
        hi = np.nextafter(r, np.float32(np.inf), dtype=np.float32)
        err = abs(fractions.Fraction(float(r)) - exact)
        for n in (lo, hi):
            other = abs(fractions.Fraction(float(n)) - exact)
            assert err < other or (err == other and
                                   int(r.view(np.int32)) % 2 == 0)


@pytest.mark.parametrize("method", ["ems", "tmm", "layered_tmm"])
def test_zero_iterations_and_clean_channel(method):
    """max_iters = 0 gives zeros, not ok, 0 iterations (as the JAX
    package); a clean channel passes at the entry of pass 0."""
    code, jax_code = synth(4)
    L = noisy_zero_llr(code, np.random.default_rng(1), batch=3)
    res = both(code, jax_code, L, method, 0)
    assert not res.ok.any() and not res.hard.any() and not res.iters.any()
    clean = np.zeros((2, code.n_sym, code.q), dtype=np.float32)
    clean[..., 1:] = -10.0
    res = nb_decode.decode(torch.from_numpy(clean), code, method, 5)
    assert res.ok.all() and not res.iters.any() and not res.hard.any()


def test_unusable_configurations_raise():
    code, _ = synth(4)
    L = torch.zeros(1, code.n_sym, code.q)
    with pytest.raises(ValueError, match="Nc >= 1"):
        nb_decode.decode(L, code, "ems", 2, nc=0)
    with pytest.raises(ValueError, match="unknown"):
        nb_decode.decode(L, code, "bogus", 2)
    dec = nb_decode.make_decoder(code, "tmm", max_iters=4)
    assert_same(dec(L), nb_decode.decode_tmm(L, code, 4))
