"""EMS at any (Nm, Nc) on the CPU: the refusal of an Nm the JAX package
refuses, and the design of K8's mode ``ems_nmnc`` (csrc/nbms.cu
``ems_nmnc_row``) emulated in torch against the plain ``_ems_cn_core``.

``ems_nmnc_row`` finds the set of an edge's top K = Nm - 1 non-zero
offsets in min(K, q - K) rounds on order keys (the float's bits, -0 as
+0): K maxima of the keys not taken yet, each at its smallest index (K <=
q - K), or all but the q - K last offsets (smallest key, largest index)
found one at a time (``top_offsets``).  That must be the set of
``jax.lax.top_k`` and ``_top_first`` on rows full of ties (a
coefficient-0 edge's W is all ties but one); the pairs list it in index
order (only the set matters to their maxima).  Then the branch
``ems_branch`` names: the pairs (each listed offset o of edge a against
the whole clipped message of edge b, dev_b[o ^ x]); the unbudgeted chains
(``chains``: fwd[1] = 0 + msg[0] in A[0], bwd[dc - 2] = 0 + msg[dc - 1] in
A[dc - 1], one step of each a phase against the inner edges' messages,
dense or, with n = K + 1 entries where 4 n <= q, as (offset, value) lists
whose step is max over the entries of A[t ^ x] + v; the inner edges'
exclusive convolutions, the end edges' 0 + bwd[0] and 0 + fwd[dc - 1]);
or the budgeted chains (``budget_chains``), whose states keep only the
levels max(1, Nc - (dc - 1 - s)) .. min(s, Nc) of a state of s messages,
laid out in one region as the kernel's shared memory (the identity, then
F's levels, then Bk's, at ``level_base``), F_1[1] and Bk's first state
max(identity, 0 + dev), each step over the kept levels, and each inner
edge's exclusive value the max of F_d[Nc] and Bk_d[Nc] where its term
range reaches c = Nc or c = 0 and of its dense terms between.  The torch
emulation follows those indices and must equal ``_ems_cn_core`` bit for
bit, the signs of zero too (tolerance: none; each term is one add and a
maximum is exact; the convolutions' split over threads is
tests/test_torch_nbms_layout.py's).  Then the plain decoder against the
JAX package at two (Nm, Nc) on registry codes, exactly.  Last, the levels
and terms of the budgeted chains that the kernel and chip_smoke's bound
leave out change nothing.  Inputs are seeded numpy.
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

def order_key(x: torch.Tensor) -> torch.Tensor:
    """csrc/nbms.cu ``order_key``: the float's bits as an order (int64
    holding the unsigned key), -0 made +0 by adding 0."""
    b = (x + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 2 ** 31, b ^ 0xFFFFFFFF, b | 2 ** 31)


def rounds(W0: torch.Tensor, K: int) -> torch.Tensor:
    """The kernel's rounds (``top_offsets``): K maxima of the keys not
    taken yet, each at its smallest index, or (K > q - K) all but the q - K
    last ones, each the smallest key left at its largest index; the taken
    mask [..., q]."""
    q = W0.shape[-1]
    up = K <= q - K
    key = order_key(W0)
    y = torch.arange(q)
    taken = torch.full_like(W0, not up, dtype=torch.bool)
    for _ in range(K if up else q - K):
        best = (key.amax if up else key.amin)(-1, keepdim=True)
        at = torch.where(key == best, y, q if up else -1)
        o = (at.amin if up else at.amax)(-1, keepdim=True)
        key.scatter_(-1, o, 0 if up else 2 ** 32 - 1)   # out of the race
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


def listed_conv(A, entries, P=None):
    """``listed_convs``: out[x] = max(P[x], max over the entries (t, v) of
    A[t ^ x] + v); A [B, M, q], entries [B, M, n] offsets and values."""
    t, v = entries
    x = torch.arange(A.shape[-1])
    out = torch.full_like(A, float("-inf")) if P is None else P.clone()
    for k in range(t.shape[-1]):
        term = torch.gather(A, -1, t[..., k, None] ^ x) + v[..., k, None]
        out = torch.maximum(out, term)
    return out


def level_lo(s, nc, dc):
    return max(1, nc - (dc - 1 - s))


def level_base(s, nc, dc):
    """csrc/nbms.cu ``level_base``, its closed form."""
    n, m = s - 1, s + nc - dc - 1
    mins = n * (n + 1) // 2 if n <= nc else nc * (nc + 1) // 2 + (n - nc) * nc
    return mins - (m * (m + 1) // 2 if m > 0 else 0)


def kernel_row(v2c, h_perm, nm, nc):
    """ems_nmnc_row on every row [B, M] at once, in the kernel's steps and
    indices: v2c [B, M, dc, q] -> c2v [B, M, dc, q]."""
    Bn, M, dc, q = v2c.shape
    K = nm - 1
    x = torch.arange(q)
    ident = identity(q).expand(Bn, M, q)
    U = nb_decode._to_cn_domain(v2c, h_perm)
    v0 = U.amax(-1)
    c0 = U.argmax(-1)
    W = torch.gather(U, -1, c0[..., None] ^ x) - v0[..., None]
    # conf(q,1): the best single deviation of the other edges
    D = [torch.stack([W[:, :, d] for d in range(dc) if d != w]).amax(0)
         for w in range(dc)]
    branch = cuda_nbms.ems_branch(nm, nc, dc)
    n = K + 1 if branch == "chains" else K
    listed = branch in ("chains", "budget") and 4 * n <= q
    if branch != "conf1":
        W0 = torch.where(x == 0, NEG, W)
        taken, lst = select(W0, K)
        dev = torch.where(taken, W0, NEG)
        # a listed message: (offsets, values) in index order (the chains'
        # offset 0, value 0, first)
        order = torch.where(taken, x, q).sort(-1).values[..., :min(K, q)]
        vals = torch.gather(dev, -1, order.clamp(max=q - 1))
        if branch == "chains":
            order = torch.cat([torch.zeros_like(order[..., :1]), order], -1)
            vals = torch.cat([torch.zeros_like(vals[..., :1]), vals], -1)
    ev = None
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

        def conv(Am, d):
            if listed:
                return listed_conv(Am, (order[:, :, d], vals[:, :, d]))
            return nb_decode._maxconv(Am, msg[:, :, d])

        fwd = {1: 0.0 + msg[:, :, 0]}                  # A[0]
        bwd = {dc - 2: 0.0 + msg[:, :, dc - 1]}        # A[dc - 1]
        for s in range(1, dc - 1):
            d = dc - 1 - s
            fwd[s + 1] = conv(fwd[s], s)
            bwd[d - 1] = conv(bwd[d], d)
        excl = {d: nb_decode._maxconv(fwd[d], bwd[d]) for d in range(1, dc - 1)}
        excl[0], excl[dc - 1] = bwd[0], fwd[dc - 1]
        ev = [0.0 + excl[w] for w in range(dc)]
    elif branch == "budget":
        nl = level_base(dc, nc, dc)
        Sb = torch.full((Bn, M, (1 + 2 * nl) * q), float("nan"))
        Sb[..., :q] = identity(q)
        F, Bk = q, (1 + nl) * q                  # offsets into the region

        def lev(chain, s, c):
            c = min(c, s, nc)
            at = chain + (level_base(s, nc, dc) + c - level_lo(s, nc, dc)) * q
            return slice(at, at + q)

        def state(chain, s, c):
            return Sb[..., :q] if c == 0 else Sb[..., lev(chain, s, c)]

        Sb[..., lev(F, 1, 1)] = torch.maximum(ident, 0.0 + dev[:, :, 0])
        Sb[..., lev(Bk, 1, 1)] = torch.maximum(ident, 0.0 + dev[:, :, dc - 1])
        for s in range(1, dc - 1):
            lo = level_lo(s + 1, nc, dc)
            for chain, d in ((F, s), (Bk, dc - 1 - s)):
                for c in range(lo, min(s + 1, nc) + 1):
                    A, P = state(chain, s, c - 1), state(chain, s, c)
                    if listed:
                        out = listed_conv(A, (order[:, :, d],
                                              vals[:, :, d]), P)
                    else:
                        out = torch.maximum(P, nb_decode._maxconv(
                            A, dev[:, :, d]))
                    Sb[..., lev(chain, s + 1, c)] = out
        ev = []
        for d in range(dc):
            r = dc - 1 - d
            lo, hi = max(0, nc - r), min(d, nc)
            e = torch.full((Bn, M, q), float("-inf"))
            if lo == 0:
                e = torch.maximum(e, state(Bk, r, nc))
            if hi == nc:
                e = torch.maximum(e, state(F, d, nc))
            for c in range(max(lo, 1), min(hi, nc - 1) + 1):
                e = torch.maximum(e, nb_decode._maxconv(
                    state(F, d, c), state(Bk, r, nc - c)))
            ev.append(0.0 + e)
    if ev is not None:
        D = [torch.maximum(D[w], ev[w]) for w in range(dc)]
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
    ("LDPC_N576_K480_GF256_exp", 100, 6), ("LDPC_N576_K480_GF256_exp", 8, 11),
]


@pytest.mark.parametrize("name,nm,nc", ROW_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in ROW_CASES])
def test_kernel_row_equals_the_plain_row(name, nm, nc):
    """Every branch of ems_nmnc_row and its selections (as the complement
    at Nm = 40, 64 and 256, every offset at Nm = q + 1, as first maxima
    below), the chains with listed messages (BDS 8/3, K480 8/11) and dense
    ones (Nm 64 and up), the budget states at both ends of
    LDPC_N576_K480_GF256_exp's Nc = 3 .. 10 and at its most levels (Nc =
    6) among them, listed (Nm 3, 8) and dense (Nm 100), against
    _ems_cn_core on one pass of messages with ties (quarter steps, -0
    among them) on 12 rows and every row with a coefficient-0 edge
    (LDPC_N576_K288_GF64_d1_exp has two): equal values and equal signs of
    zero."""
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
    ours = kernel_row(v2c, h_perm, nm, nc)
    assert torch.equal(ours, plain)
    assert torch.equal(torch.signbit(ours), torch.signbit(plain))


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
