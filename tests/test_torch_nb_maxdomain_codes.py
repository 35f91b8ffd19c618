"""The port's plain max-domain GF(q) decoders (cuda_ldpc_torch.ops.nb_decode)
on the registry codes BDS.576.288.GF.64 and LDPC_N576_K288_GF64_d1_exp
against the JAX package's ``nb_decode`` and the loop oracle
tests/oracle_nb.py, on the same numpy inputs, on the CPU: whole decodes,
the layered TMM state after a pass, and grouped-layered TMM as layered TMM
in group order.  The synthetic-code cases, the CN cores and the helpers are
in tests/test_torch_nb_maxdomain.py; the two files share the cost of the
JAX compiles between two test workers.

Tolerance: none, as there: hard, ok and iters agree exactly, and so do the
decoder states after a pass.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu.ops import nb_decode as jax_nb
from cuda_ldpc_torch.ops import nb_decode

from test_nb_decode import noisy_zero_llr, run_oracle
from test_torch_nb_decode import channel_llr, codes
from test_torch_nb_maxdomain import both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# Eb/N0 per (code, method) where, at 3 iterations, some of the 8 frames
# converge and some do not (EMS Nm=2/Nc=2 on the code with coefficient-0
# edges converges only at pass 0, in both packages).
REGISTRY_CASES = [
    ("BDS.576.288.GF.64", "ems", 4.5),
    ("BDS.576.288.GF.64", "ems_full", 3.5),
    ("BDS.576.288.GF.64", "tmm", 4.5),
    ("BDS.576.288.GF.64", "layered_tmm", 3.0),
    ("LDPC_N576_K288_GF64_d1_exp", "ems", 10.0),
    ("LDPC_N576_K288_GF64_d1_exp", "ems_full", 4.5),
    ("LDPC_N576_K288_GF64_d1_exp", "tmm", 4.5),
    ("LDPC_N576_K288_GF64_d1_exp", "layered_tmm", 3.0),
]


@pytest.mark.parametrize("name,method,ebn0", REGISTRY_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in REGISTRY_CASES])
def test_registry_codes_match_jax(name, method, ebn0):
    """BDS.576.288.GF.64 and LDPC_N576_K288_GF64_d1_exp (two coefficient-0
    edges) at 3 iterations."""
    code, jax_code = codes(name)
    L = channel_llr(code, 8, ebn0, seed=5)
    ours = both(code, jax_code, L, method, 3)
    assert 0 < int(ours.ok.sum()) < 8


def rows_in_order(code, order):
    """``code`` with its check rows renumbered: new row i is old row
    order[i]."""
    inv = np.empty(len(order), dtype=np.int64)
    inv[order] = np.arange(len(order))
    vn_links = np.where(code.vn_mask, inv[code.vn_links], 0)
    return dataclasses.replace(
        code, cn_weight=code.cn_weight[order], cn_links=code.cn_links[order],
        cn_gf=code.cn_gf[order], cn_mask=code.cn_mask[order],
        cn_slot=code.cn_slot[order],
        vn_links=vn_links.astype(code.vn_links.dtype))


@pytest.mark.parametrize("name", ["BDS.576.288.GF.64",
                                  "LDPC_N576_K288_GF64_d1_exp"])
def test_glayered_tmm_is_layered_tmm_in_group_order(name):
    """Grouped-layered TMM on a registry code is layered TMM with the rows
    in group order: the rows of a group share no VN, so updating them at
    once equals updating them one by one.  Layered TMM is held to the JAX
    package on both codes, grouped-layered on the synthetic one (the JAX
    grouped-layered decoder takes ~9 s to compile on a registry code)."""
    code, _ = codes(name)
    g = nb_decode.build_graph(code)
    order = np.concatenate(nb_decode.row_groups(g.cn_links, g.cn_mask))
    assert sorted(order.tolist()) != order.tolist()
    L = torch.from_numpy(channel_llr(code, 8, 3.0, seed=5))
    ours = nb_decode.decode(L, code, "glayered_tmm", 3)
    serial = nb_decode.decode(L, rows_in_order(code, order), "layered_tmm", 3)
    for a, b in zip(ours, serial):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert 0 < int(ours.ok.sum()) < 8


@pytest.mark.parametrize("method", ["ems", "tmm"])
def test_bds_matches_oracle(method):
    """The JAX package's flagship-code oracle case (tests/test_nb_decode.py
    test_shipped_gf64_code)."""
    code, _ = codes("BDS.576.288.GF.64")
    L = noisy_zero_llr(code, np.random.default_rng(3), batch=2, scale=4.0)
    ours = nb_decode.decode(torch.from_numpy(L), code, method, 3)
    hard, ok, iters = run_oracle(code, L, method, 3)
    np.testing.assert_array_equal(ours.hard.numpy(), hard)
    np.testing.assert_array_equal(ours.ok.numpy(), ok)
    np.testing.assert_array_equal(ours.iters.numpy(), iters)


def test_layered_tmm_state_matches_jax():
    """The totals and messages after one layered TMM pass, bit for bit: the
    write-back T + ((v2c + 0.8 x) - T) with the multiply-add fused, as XLA
    compiles it."""
    code, jax_code = codes("BDS.576.288.GF.64")
    L = channel_llr(code, 3, 1.0, seed=3)
    ours, theirs = (nb_decode.build_core(code, "layered_tmm"),
                    jax_nb.build_core(jax_code, "layered_tmm"))
    pc = ours.init(torch.from_numpy(L))
    jc = theirs.init(jnp.asarray(L))
    cont = np.ones(3, dtype=bool)
    pc = ours.step(pc, ours.decide(pc)[1], torch.from_numpy(cont))
    jc = jax.jit(theirs.step)(jc, theirs.decide(jc)[1], jnp.asarray(cont))
    for a, b in zip(pc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
