"""The CUDA GF(q) FFT-QSPA decoders (cuda_ldpc_torch.ops.cuda_qspa, K5, in
each of its designs, and .cuda_qspa_qc, K6, whose staged kernel is also held
to its global-memory design) against their plain PyTorch versions.  Tolerance: none —
the kernels do the plain version's fp32 operations in its order (its
docstring fixes them), and the card's expf/logf equal torch.exp/torch.log
there, so hard, ok and iters must be exactly equal.

The kernel cases need a card and skip without one.  The file imports only
the port, so on a machine with a card and no JAX it runs on its own:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_qspa.py
"""

import numpy as np
import pytest
import torch

from cuda_ldpc_torch import NBCode
from cuda_ldpc_torch.ops import channel, cuda_qspa, cuda_qspa_qc, demod
from cuda_ldpc_torch.ops import nb_decode
from cuda_ldpc_torch.utils.constellations import constellation


def _llr(code, ebn0, batch, seed, device, n_qam=2):
    """Symbol LLRs of the all-zero codeword over BPSK or QAM + AWGN."""
    sigma = channel.sigma_from_snr(ebn0, code.rate, "ebn0",
                                   float(np.log2(n_qam)))
    labels = np.zeros(code.bit_length if n_qam == 2 else code.n_sym,
                      dtype=np.int64)
    g = torch.Generator(device=device).manual_seed(seed)
    return demod.nb_channel_llr(g, labels, constellation(n_qam), sigma,
                                batch, code.q, device=device)


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------- CPU side

@pytest.mark.parametrize("module", [cuda_qspa, cuda_qspa_qc])
def test_wrappers_refuse_other_devices(module):
    code = NBCode.from_registry("LDPC_N96_K48_GF256_d1_exp")
    L = torch.empty((1, code.n_sym, code.q), device="meta")
    with pytest.raises(ValueError, match="device"):
        module.decode_flooding(L, code, 3)


def test_shared_memory_plans():
    """K5 keeps one frame's totals in shared memory: 221,184 B of totals
    and messages would not leave room for the row's spectra on
    LDPC_N576_K480_GF256_exp, so the messages live in device memory and
    the block asks for the totals, the spectra and the tables only."""
    code = NBCode.from_registry("LDPC_N576_K480_GF256_exp")
    plan = cuda_qspa.make_plan(code)
    assert (plan.N + plan.E) * plan.q * 4 == 221_184
    assert cuda_qspa.smem_bytes(plan) == 4 * (72 * 256 + 12 * 256 + 256 + 510
                                              + 72)
    assert cuda_qspa.smem_bytes(plan) <= cuda_qspa.SMEM_LIMIT
    tanner = NBCode.from_registry("Tanner_74_9_Z128_GF16")
    assert not cuda_qspa.supports(tanner)          # q = 16: not K5's
    # K6's staged kernel: two stages of [21, 256] f32 totals and messages,
    # two of [21, 16] coefficient logs, 9,472 decisions as bytes, the int
    # tables; its global-memory design: two [21, 512] f32 arrays, GF tables
    plan = cuda_qspa_qc.make_plan(tanner)
    assert cuda_qspa_qc.smem_bytes(plan) == (4 * 4 * 21 * 256 + 2 * 21 * 16
                                             + 9472 + 4 * (16 + 30 + 10
                                                           + 3 * 185 + 75))
    assert 2 * (cuda_qspa_qc.smem_bytes(plan) + 1024) <= 228 * 1024
    assert cuda_qspa_qc.global_smem_bytes(16, 21) == 4 * (2 * 21 * 512 + 16
                                                          + 30)


# --------------------------------------------------------------- card side

K5_CASES = [
    # code, Eb/N0, batch, iterations, QAM order (the QAM order must equal
    # q: BPSK, 64-QAM on GF(64), 256-QAM on GF(256)); batches of 11 and 37
    # leave the last warps of a block's waves idle
    ("BDS.576.288.GF.64", 1.0, 64, 20, 2),
    ("BDS.576.288.GF.64", 1.5, 11, 20, 2),
    ("BDS.576.288.GF.64", 3.0, 32, 10, 64),
    ("BDS.576.288.GF.64", 1.5, 16, 0, 2),
    ("LDPC_N576_K288_GF64_d1_exp", 2.0, 32, 20, 2),
    ("LDPC_N576_K288_GF64_d1_exp", 4.0, 37, 20, 64),
    ("LDPC_N96_K48_GF256_d1_exp", 2.0, 64, 20, 2),
    ("LDPC_N96_K48_GF256_d1_exp", 6.0, 64, 20, 256),
    ("LDPC_N96_K48_GF256_d1_exp", 6.0, 37, 20, 256),
    ("LDPC_N576_K480_GF256_exp", 3.0, 32, 20, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("name,ebn0,batch,iters,n_qam", K5_CASES,
                         ids=[f"{c[0]}-{c[4]}qam-it{c[3]}-B{c[2]}"
                              for c in K5_CASES])
def test_k5_matches_plain_on_card(cuda, layered, name, ebn0, batch, iters,
                                  n_qam):
    """The kernel in the layout the dispatch rule picks, and every design
    the code takes (the serial design, a warp an edge on row groups, a row
    on one warp where it fits), against the plain version: hard, ok and
    iters of every frame.  The main path's call is counted under its
    schedule and under the design the rule picks."""
    code = NBCode.from_registry(name)
    plan = cuda_qspa.make_plan(code)
    L = _llr(code, ebn0, batch, batch + iters, cuda, n_qam)
    schedule = "layered" if layered else "flooding"
    before = dict(cuda_qspa.LAUNCHES)
    kernel = cuda_qspa.decode_layered if layered else cuda_qspa.decode_flooding
    plain = (nb_decode.decode_layered_qspa if layered
             else nb_decode.decode_qspa)
    designs = [d for d in cuda_qspa.DESIGNS
               if d != "warp" or cuda_qspa.warp_fits(plan)]
    assert ("warp" in designs) == (name in ("BDS.576.288.GF.64",
                                            "LDPC_N576_K288_GF64_d1_exp"))
    a, b = kernel(L, code, iters), plain(L, code, iters)
    each = {d: cuda_qspa.decode_design(L, code, iters, layered, d)
            for d in designs}
    torch.cuda.synchronize()
    _assert_same(a, b)
    for got in each.values():
        _assert_same(got, b)
    picked = cuda_qspa.row_layout(plan)
    assert cuda_qspa.LAUNCHES[f"qspa_{schedule}"] == (
        before[f"qspa_{schedule}"] + (iters > 0))
    for d in designs:
        key = f"qspa_{d}_{schedule}"
        assert cuda_qspa.LAUNCHES[key] == before[key] + (iters > 0) * (
            1 + (d == picked))


@pytest.mark.cuda
@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("name,batch", [("BDS.576.288.GF.64", 512),
                                        ("LDPC_N576_K288_GF64_d1_exp", 37)])
def test_k5_row_on_a_warp_at_a_larger_batch(cuda, name, batch, layered):
    """A row on one warp (flooding with each frame's C on chip, layered
    with it in device memory) at a batch of many blocks an SM, against
    the plain version, every frame."""
    code = NBCode.from_registry(name)
    L = _llr(code, 1.5, batch, 3, cuda)
    got = cuda_qspa.decode_design(L, code, 20, layered, "warp")
    want = (nb_decode.decode_layered_qspa if layered
            else nb_decode.decode_qspa)(L, code, 20)
    torch.cuda.synchronize()
    _assert_same(got, want)


@pytest.mark.cuda
def test_k5_blocks_per_sm(cuda):
    """The occupancy calculator takes every design of BDS: a row on one
    warp holds 3 frames an SM flooding (C on chip), 8 layered."""
    plan = cuda_qspa.make_plan(NBCode.from_registry("BDS.576.288.GF.64"))
    for layered in (False, True):
        got = {d: cuda_qspa.blocks_per_sm(plan, layered, d, cuda)
               for d in cuda_qspa.DESIGNS}
        assert all(v >= 1 for v in got.values()), got
        assert got["warp"] == (8 if layered else 3), got


def _synthetic_qc(q):
    """The fully QC layout of tests/test_pallas_qspa_qc.py, small: 6 x 2
    circulants of Z = 128, random shifts and coefficients."""
    from cuda_ldpc_torch.utils.io import NBCodeFile
    rng = np.random.default_rng(0)
    Z, NB, MB = 128, 6, 2
    N, M = NB * Z, MB * Z
    cn_links = np.zeros((M, NB), np.int64)
    cn_gf = rng.integers(1, q, (M, NB))
    vn_links = np.zeros((N, MB), np.int64)
    vn_gf = np.zeros((N, MB), np.int64)
    for r in range(MB):
        for c in range(NB):
            s = int(rng.integers(0, Z))
            for z in range(Z):
                v = c * Z + (z + s) % Z
                cn_links[r * Z + z, c] = v
                vn_links[v, r] = r * Z + z
                vn_gf[v, r] = cn_gf[r * Z + z, c]
    return NBCode.from_file(NBCodeFile(
        N, M, q, MB, NB, np.full(N, MB), np.full(M, NB), vn_links, vn_gf,
        cn_links, cn_gf), name=f"synthetic_gf{q}")


K6_CASES = [
    # code, Eb/N0, batch, early stop
    ("synthetic_gf16", 2.5, 5, True),
    ("synthetic_gf4", 2.5, 37, True),
    ("synthetic_gf32", 3.0, 37, True),
    ("Tanner_74_9_Z128_GF16", 4.3, 11, True),
    ("Tanner_74_9_Z128_GF16", 3.3, 64, False),     # the waterfall
]


@pytest.mark.cuda
@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("name,ebn0,batch,early", K6_CASES,
                         ids=[f"{c[0]}-{c[1]}dB-B{c[2]}" for c in K6_CASES])
def test_k6_matches_plain_on_card(cuda, layered, name, ebn0, batch, early):
    """The staged kernel against the plain version and against the global
    design (the earlier kernel, the yardstick): every output of every
    frame."""
    code = (_synthetic_qc(int(name[len("synthetic_gf"):]))
            if name.startswith("synthetic") else NBCode.from_registry(name))
    assert cuda_qspa_qc.supports(code)
    L = _llr(code, ebn0, batch, 7, cuda)
    key = "qspa_qc_layered" if layered else "qspa_qc_flooding"
    before = dict(cuda_qspa_qc.LAUNCHES)
    kernel = (cuda_qspa_qc.decode_layered if layered
              else cuda_qspa_qc.decode_flooding)
    yardstick = (cuda_qspa_qc.decode_layered_global if layered
                 else cuda_qspa_qc.decode_flooding_global)
    plain = (nb_decode.decode_glayered_qspa if layered
             else nb_decode.decode_qspa)
    a = kernel(L, code, 12, early_stop=early)
    g = yardstick(L, code, 12, early_stop=early)
    b = plain(L, code, 12, early_stop=early)
    torch.cuda.synchronize()
    _assert_same(a, b)
    _assert_same(a, g)
    assert cuda_qspa_qc.LAUNCHES[key] == before[key] + 1
    assert cuda_qspa_qc.LAUNCHES[key + "_global"] == (
        before[key + "_global"] + 1)


@pytest.mark.cuda
def test_kernels_reject_what_they_cannot_take(cuda):
    code = NBCode.from_registry("BDS.576.288.GF.64")
    L = _llr(code, 2.0, 4, 0, cuda)
    with pytest.raises(TypeError, match="float32"):
        cuda_qspa.decode_flooding(L.double(), code, 2)
    with pytest.raises(ValueError, match=r"\[B, 96, 64\]"):
        cuda_qspa.decode_flooding(L[:, :90].contiguous(), code, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_qspa.decode_flooding(L.transpose(0, 1).contiguous()
                                  .transpose(0, 1), code, 2)
    with pytest.raises(ValueError, match="does not take"):
        cuda_qspa_qc.decode_flooding(L, code, 2)
    empty = cuda_qspa.decode_layered(L[:0], code, 5)
    assert empty.hard.shape == (0, 96) and empty.hard.is_cuda
