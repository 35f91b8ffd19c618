"""The CUDA GF(q) FFT-QSPA decoders (cuda_ldpc_torch.ops.cuda_qspa, K5, and
.cuda_qspa_qc, K6) against their plain PyTorch versions.  Tolerance: none —
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
    assert cuda_qspa_qc.smem_bytes(16, 21) == 4 * (2 * 21 * 512 + 16 + 30)


# --------------------------------------------------------------- card side

K5_CASES = [
    # code, Eb/N0, batch, iterations, QAM order
    ("BDS.576.288.GF.64", 1.0, 64, 20, 2),
    ("BDS.576.288.GF.64", 1.5, 11, 20, 2),
    ("BDS.576.288.GF.64", 3.0, 32, 10, 64),
    ("BDS.576.288.GF.64", 1.5, 16, 0, 2),
    ("LDPC_N576_K288_GF64_d1_exp", 2.0, 32, 20, 2),
    ("LDPC_N96_K48_GF256_d1_exp", 2.0, 64, 20, 2),
    ("LDPC_N96_K48_GF256_d1_exp", 6.0, 64, 20, 256),
    ("LDPC_N576_K480_GF256_exp", 3.0, 32, 20, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("name,ebn0,batch,iters,n_qam", K5_CASES,
                         ids=[f"{c[0]}-{c[4]}qam-it{c[3]}-B{c[2]}"
                              for c in K5_CASES])
def test_k5_matches_plain_on_card(cuda, layered, name, ebn0, batch, iters,
                                  n_qam):
    code = NBCode.from_registry(name)
    L = _llr(code, ebn0, batch, batch + iters, cuda, n_qam)
    key = "qspa_layered" if layered else "qspa_flooding"
    before = cuda_qspa.LAUNCHES[key]
    kernel = cuda_qspa.decode_layered if layered else cuda_qspa.decode_flooding
    plain = (nb_decode.decode_layered_qspa if layered
             else nb_decode.decode_qspa)
    a, b = kernel(L, code, iters), plain(L, code, iters)
    torch.cuda.synchronize()
    _assert_same(a, b)
    assert cuda_qspa.LAUNCHES[key] == before + (iters > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("name,ebn0,batch", [("synthetic", 2.5, 5),
                                             ("Tanner_74_9_Z128_GF16", 4.3,
                                              11)])
def test_k6_matches_plain_on_card(cuda, layered, name, ebn0, batch):
    if name == "synthetic":
        # the fully QC GF(16) layout of tests/test_pallas_qspa_qc.py, small
        rng = np.random.default_rng(0)
        from cuda_ldpc_torch.utils.io import NBCodeFile
        Z, NB, MB, q = 128, 6, 2, 16
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
        code = NBCode.from_file(NBCodeFile(
            N, M, q, MB, NB, np.full(N, MB), np.full(M, NB), vn_links, vn_gf,
            cn_links, cn_gf), name="synthetic")
    else:
        code = NBCode.from_registry(name)
    assert cuda_qspa_qc.supports(code)
    L = _llr(code, ebn0, batch, 7, cuda)
    key = "qspa_qc_layered" if layered else "qspa_qc_flooding"
    before = cuda_qspa_qc.LAUNCHES[key]
    kernel = (cuda_qspa_qc.decode_layered if layered
              else cuda_qspa_qc.decode_flooding)
    plain = (nb_decode.decode_glayered_qspa if layered
             else nb_decode.decode_qspa)
    a, b = kernel(L, code, 12), plain(L, code, 12)
    torch.cuda.synchronize()
    _assert_same(a, b)
    assert cuda_qspa_qc.LAUNCHES[key] == before + 1


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
