"""EMS at any (Nm, Nc) on the CPU: the refusal of an Nm the JAX package
refuses, and the design of K8's mode ``ems_nmnc`` (csrc/nbms.cu
``ems_nmnc_row``) emulated in torch against the plain ``_ems_cn_core``.

``ems_nmnc_row`` finds the set of an edge's top K = Nm - 1 non-zero
offsets in min(K, q - K) rounds: K first-index maxima over the offsets
not taken yet (K <= q - K), or all but the q - K last offsets (smallest
value, largest index) found one at a time.  That must be the set of
``jax.lax.top_k`` and ``_top_first`` on rows full of ties (a
coefficient-0 edge's W is all ties but one); the pairs list it in index
order (only the set matters to their maxima).  Then the branch
``ems_branch`` names: the pairs (each listed offset o of edge a against
the whole clipped message of edge b, dev_b[o ^ x]), the unbudgeted chains,
or the budgeted chains, whose states the kernel keeps in device memory at
F[(d (Nc + 1) + c) q], Bk after F, level 0 and the ends the identity,
F[s + 1][c] = max(F[s][c], maxconv(F[s][c - 1], dev_s)) and Bk likewise
from the right, the exclusive values max over c of maxconv(F[d][c],
Bk[d][Nc - c]) from c = 0 up.  The torch emulation follows those indices
and must equal ``_ems_cn_core`` bit for bit (tolerance: none; each term
is one add and a maximum is exact; the convolutions' split over threads is
tests/test_torch_nbms_layout.py's).  Then the plain decoder against the
JAX package at two (Nm, Nc) on registry codes, exactly.  Last, the levels
and terms of the budgeted chains that chip_smoke's bound leaves out
change nothing.  Inputs are seeded numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu.ops import nb_decode as jax_nb
from cuda_ldpc_torch.ops import cuda_nbms, nb_decode

from test_torch_nb_decode import channel_llr, codes

NEG = nb_decode.NEG


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------- the refusal

@pytest.mark.parametrize("name,nm,nc", [
    ("BDS.576.288.GF.64", 66, 2),             # the pairs
    ("BDS.576.288.GF.64", 66, 3),             # the chains
    ("LDPC_N96_K48_GF256_d1_exp", 300, 2),
])
def test_an_nm_beyond_q_is_refused_as_the_jax_package_refuses_it(name, nm,
                                                                 nc):
    """Nm - 1 > q: jax.lax.top_k refuses the JAX package's EMS, and the
    port's build_core refuses it before any pass; the kernel does not
    take it.  Nm - 1 = q, and any Nm with Nc = 1 (no selection), stand."""
    code, jax_code = codes(name)
    L = np.zeros((1, code.n_sym, code.q), dtype=np.float32)
    with pytest.raises(ValueError, match="top_k"):
        jax_nb.decode(jnp.asarray(L), jax_code, "ems", 2, nm=nm, nc=nc)
    with pytest.raises(ValueError, match="Nm - 1 <= q"):
        nb_decode.decode(torch.from_numpy(L), code, "ems", 2, nm=nm, nc=nc)
    assert not cuda_nbms.supports(code, nm=nm, nc=nc)
    for ok_nm, ok_nc in [(code.q + 1, nc), (nm, 1)]:
        nb_decode.build_core(code, "ems", nm=ok_nm, nc=ok_nc)
        assert cuda_nbms.supports(code, nm=ok_nm, nc=ok_nc)


# ------------------------------------------------------- the selection

def rounds(W0: torch.Tensor, K: int) -> torch.Tensor:
    """The kernel's rounds: K first-index maxima of the offsets not taken
    yet, or (K > q - K) all but the q - K last ones, each the smallest
    value left with the largest index; the taken mask [..., q]."""
    q = W0.shape[-1]
    up = K <= q - K
    cur = W0.clone()
    taken = torch.full_like(W0, not up, dtype=torch.bool)
    for _ in range(K if up else q - K):
        if up:
            o = cur.argmax(-1, keepdim=True)        # the first maximum
        else:                                       # the last minimum
            o = q - 1 - cur.flip(-1).argmin(-1, keepdim=True)
        cur.scatter_(-1, o, float("-inf") if up else float("inf"))
        taken.scatter_(-1, o, up)
    return taken


def select(W0: torch.Tensor, K: int):
    """The kernel's selection on rows W0 [..., q]: (taken [..., q] bool,
    the pairs' list [..., min(K, q)] of the taken offsets in index order)."""
    q = W0.shape[-1]
    y = torch.arange(q)
    if K >= q:
        taken = torch.ones_like(W0, dtype=torch.bool)
    else:
        taken = rounds(W0, K)
    lst = torch.where(taken, y, q).sort(-1).values[..., :min(K, q)]
    return taken, lst


def tie_rows(q: int, seed: int) -> torch.Tensor:
    """Delta rows W0 [6, q] with offset 0 at NEG: few levels (ties
    everywhere), all equal (a coefficient-0 edge whose sum is its
    maximum), one better (its sum below 0), distinct values."""
    rng = np.random.default_rng(seed)
    rows = [np.round(rng.normal(size=q) * 1.5) / 2 - 3,
            np.round(rng.normal(size=q)) - 1,
            np.full(q, -2.5),
            np.where(np.arange(q) == 1, -1.0, -4.0),
            rng.normal(size=q) - 2,
            np.where(rng.random(q) < 0.5, -1.0, -1.5)]
    W0 = torch.tensor(np.stack(rows), dtype=torch.float32)
    W0[:, 0] = NEG
    return W0


@pytest.mark.parametrize("q", [64, 256])
def test_selection_is_top_k(q):
    """The rounds' taken offsets are the set of jax.lax.top_k and
    _top_first (whose values and indices agree), and the pairs' list holds
    that set in index order, for K on both sides of q / 2 and at its
    ends."""
    W0 = tie_rows(q, q)
    for K in (1, 2, 3, 15, 19, q // 2, q // 2 + 1, q - 19, q - 2, q - 1, q):
        P, O = nb_decode._top_first(W0, K)
        jP, jO = jax.lax.top_k(jnp.asarray(W0.numpy()), K)
        np.testing.assert_array_equal(O.numpy(), np.asarray(jO))
        np.testing.assert_array_equal(P.numpy(), np.asarray(jP))
        member = torch.zeros_like(W0, dtype=torch.bool).scatter(-1, O, True)
        taken, lst = select(W0, K)
        assert torch.equal(taken, member)
        assert torch.equal(lst, O.sort(-1).values)


# ------------------------------------------------------- the row

def identity(q: int) -> torch.Tensor:
    return torch.where(torch.arange(q) == 0, 0.0, NEG)


def kernel_row(v2c, h_perm, nm, nc):
    """ems_nmnc_row on every row [B, M] at once, in the kernel's steps and
    indices: v2c [B, M, dc, q] -> c2v [B, M, dc, q]."""
    Bn, M, dc, q = v2c.shape
    K = nm - 1
    x = torch.arange(q)
    U = nb_decode._to_cn_domain(v2c, h_perm)
    v0 = U.amax(-1)
    c0 = U.argmax(-1)
    W = torch.gather(U, -1, c0[..., None] ^ x) - v0[..., None]
    # conf(q,1): the best single deviation of the other edges
    D = [torch.stack([W[:, :, d] for d in range(dc) if d != w]).amax(0)
         for w in range(dc)]
    branch = cuda_nbms.ems_branch(nm, nc, dc)
    if branch != "conf1":
        W0 = torch.where(x == 0, NEG, W)
        taken, lst = select(W0, K)
        dev = torch.where(taken, W0, NEG)
    if branch == "pairs":
        for w in range(dc):
            for a in range(dc):
                for b in range(a + 1, dc):
                    if w in (a, b):
                        continue
                    for ka in range(min(K, q)):
                        o = lst[:, :, a, ka]
                        p = torch.gather(dev[:, :, a], -1, o[..., None])
                        t = p + torch.gather(dev[:, :, b], -1,
                                             o[..., None] ^ x)
                        D[w] = torch.maximum(D[w], t)
    elif branch == "chains":
        msg = torch.maximum(dev, identity(q))
        Y = [identity(q).expand(Bn, M, q)] + [None] * (dc - 1)   # fwd
        X = [None] * (dc - 1) + [identity(q).expand(Bn, M, q)]   # bwd
        for s in range(dc - 1):
            d = dc - 1 - s
            Y[s + 1] = nb_decode._maxconv(Y[s], msg[:, :, s])
            X[d - 1] = nb_decode._maxconv(X[d], msg[:, :, d])
        for w in range(dc):
            D[w] = torch.maximum(D[w], nb_decode._maxconv(Y[w], X[w]))
    elif branch == "budget":
        L1, Q = nc + 1, q
        St = torch.empty(Bn, M, 2 * dc * L1 * Q)
        F, Bk = 0, dc * L1 * Q                      # offsets into St

        def at(base, d, c):
            return slice(base + (d * L1 + c) * Q, base + (d * L1 + c + 1) * Q)

        ident = identity(q)
        for d in range(dc):
            for c in range(L1):
                if d == 0 or c == 0:
                    St[..., at(F, d, c)] = ident
                if d == dc - 1 or c == 0:
                    St[..., at(Bk, d, c)] = ident
        for s in range(dc - 1):
            d = dc - 1 - s
            for job in range(2 * nc):
                if job < nc:
                    c = job + 1
                    a, bb = at(F, s, c - 1), dev[:, :, s]
                    o, p = at(F, s + 1, c), at(F, s, c)
                else:
                    c = job - nc + 1
                    a, bb = at(Bk, d, c - 1), dev[:, :, d]
                    o, p = at(Bk, d - 1, c), at(Bk, d, c)
                St[..., o] = torch.maximum(
                    St[..., p], nb_decode._maxconv(St[..., a], bb))
        Xe = [nb_decode._maxconv(St[..., at(F, d, 0)], St[..., at(Bk, d, nc)])
              for d in range(dc)]
        for c in range(1, nc + 1):
            Xe = [torch.maximum(Xe[d], nb_decode._maxconv(
                St[..., at(F, d, c)], St[..., at(Bk, d, nc - c)]))
                for d in range(dc)]
        D = [torch.maximum(D[w], Xe[w]) for w in range(dc)]
    D = torch.stack(D, dim=2)                                # [B, M, dc, q]
    g0 = torch.zeros_like(c0[:, :, 0])
    for d in range(dc):
        g0 = g0 ^ c0[:, :, d]
    g0 = g0[:, :, None] ^ c0
    idx = torch.where(h_perm[..., 1:2] != 0, h_perm, 0)[None] ^ g0[..., None]
    out = torch.gather(D, -1, idx)
    d0 = torch.gather(D, -1, g0[..., None])
    return (out - d0) * nb_decode.EMS_SCALE


ROW_CASES = [
    ("BDS.576.288.GF.64", 1, 2), ("BDS.576.288.GF.64", 3, 1),
    ("BDS.576.288.GF.64", 4, 2), ("BDS.576.288.GF.64", 65, 2),
    ("BDS.576.288.GF.64", 8, 3), ("BDS.576.288.GF.64", 65, 3),
    ("LDPC_N576_K288_GF64_d1_exp", 4, 2),
    ("LDPC_N576_K288_GF64_d1_exp", 64, 3),
    ("LDPC_N576_K288_GF64_d1_exp", 40, 2),
    ("LDPC_N96_K48_GF256_d1_exp", 256, 3),
    ("LDPC_N576_K480_GF256_exp", 3, 3), ("LDPC_N576_K480_GF256_exp", 8, 10),
]


@pytest.mark.parametrize("name,nm,nc", ROW_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in ROW_CASES])
def test_kernel_row_equals_the_plain_row(name, nm, nc):
    """Every branch of ems_nmnc_row and its selections (as the complement
    at Nm = 40, 64 and 256, every offset at Nm = q + 1, as first maxima
    below), the budget states at both ends of LDPC_N576_K480_GF256_exp's
    Nc = 3 .. 10 among them, against _ems_cn_core on one pass of messages
    with ties (quarter steps) on 12 rows and every row with a
    coefficient-0 edge (LDPC_N576_K288_GF64_d1_exp has two)."""
    code, _ = codes(name)
    g = nb_decode.build_graph(code)
    zero = np.nonzero((g.h_perm[..., 1] == 0).any(-1))[0]
    rows = sorted(set(range(min(12, g.M))) | set(zero.tolist()))
    assert bool(len(zero)) == (name == "LDPC_N576_K288_GF64_d1_exp")
    h_perm = torch.as_tensor(g.h_perm[rows])
    mask = torch.as_tensor(g.cn_mask[rows])
    rng = np.random.default_rng(nm * 100 + nc)
    v2c = np.round(rng.normal(size=(1, len(rows), g.dc, g.q)) * 4) / 4
    v2c[..., 0] = 0.0
    v2c = torch.from_numpy(v2c.astype(np.float32))
    plain = nb_decode._ems_cn_core(v2c, mask, h_perm, nm, nc, g.dc, g.q)
    assert torch.equal(kernel_row(v2c, h_perm, nm, nc), plain)


# ------------------------------------------------------- the plain decoder

@pytest.mark.parametrize("name,nm,nc,batch,iters,ebn0", [
    ("LDPC_N576_K288_GF64_d1_exp", 4, 2, 4, 4, 2.0),
    ("LDPC_N576_K480_GF256_exp", 3, 3, 2, 2, 3.0),    # budgeted
])
def test_plain_matches_jax(name, nm, nc, batch, iters, ebn0):
    """The port's plain EMS against the JAX package's on the same numpy
    LLRs: hard, ok and iters exactly equal."""
    code, jax_code = codes(name)
    L = channel_llr(code, batch, ebn0, seed=nm + nc)
    ours = nb_decode.decode(torch.from_numpy(L), code, "ems", iters,
                            nm=nm, nc=nc)
    theirs = jax_nb.decode(jnp.asarray(L), jax_code, "ems", iters, nm=nm,
                           nc=nc)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------- the bound's count

@pytest.mark.parametrize("dc,nc", [(12, 10), (12, 3), (7, 4)])
def test_budgeted_terms_the_bound_leaves_out_change_nothing(dc, nc):
    """chip_smoke.nbms_bound_ms counts, of the budgeted chains, only the
    levels a state of s messages can tell apart (F_s[c] = F_s[s] for c >
    s) and only the exclusive terms maxconv(F_d[c], Bk_d[nc - c]) with nc
    - (dc - 1 - d) <= c <= d, the others dominated.  Both hold exactly on
    the plain version's chains (its ``extend``), here on seeded clipped
    messages with ties at q = 16."""
    q, K = 16, 5
    rng = np.random.default_rng(dc * 100 + nc)
    W = torch.from_numpy(
        (np.round(rng.normal(size=(dc, q)) * 4) / 4 - 1).astype(np.float32))
    W[:, 0] = NEG
    P, O = nb_decode._top_first(W, K)
    dev = torch.full_like(W, NEG).scatter(-1, O, P)
    ident = identity(q)

    def extend(states, d):
        return [states[0]] + [
            torch.maximum(states[c], nb_decode._maxconv(states[c - 1],
                                                        dev[d]))
            for c in range(1, nc + 1)]

    fwd = [[ident] * (nc + 1)]
    for d in range(dc - 1):
        fwd.append(extend(fwd[-1], d))
    bwd = [[ident] * (nc + 1)]
    for d in range(dc - 1, 0, -1):
        bwd.append(extend(bwd[-1], d))
    bwd = bwd[::-1]
    for d in range(dc):
        for c in range(nc + 1):
            assert torch.equal(fwd[d][c], fwd[d][min(c, d)])
            assert torch.equal(bwd[d][c], bwd[d][min(c, dc - 1 - d)])
        terms = [nb_decode._maxconv(fwd[d][c], bwd[d][nc - c])
                 for c in range(nc + 1)]
        lo, hi = max(0, nc - (dc - 1 - d)), min(d, nc)
        assert torch.equal(torch.stack(terms).amax(0),
                           torch.stack(terms[lo:hi + 1]).amax(0))
