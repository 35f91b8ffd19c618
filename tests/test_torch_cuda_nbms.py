"""The CUDA GF(q) max-domain decoder (cuda_ldpc_torch.ops.cuda_nbms, K8:
EMS Nm=2/Nc=2, TMM, layered TMM) against its plain PyTorch version.
Tolerance: none — the kernel does the plain version's fp32 operations in
its order (ops/nb_decode.py's docstring fixes them; max, min and the GF
tables are exact), so hard, ok and iters must be exactly equal, and so
must its row groups' and its serial design's (``decode_*_serial``).

The kernel cases need a card and skip without one.  The file imports only
the port, so on a machine with a card and no JAX it runs on its own:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_nbms.py
"""

import numpy as np
import pytest
import torch

from cuda_ldpc_torch import NBCode
from cuda_ldpc_torch.ops import channel, cuda_nbms, demod, nb_decode
from cuda_ldpc_torch.utils.constellations import constellation

METHODS = {"ems": (cuda_nbms.decode_ems, nb_decode.decode_ems),
           "tmm": (cuda_nbms.decode_tmm, nb_decode.decode_tmm),
           "layered_tmm": (cuda_nbms.decode_layered_tmm,
                           nb_decode.decode_layered_tmm)}
SERIAL = {"ems": cuda_nbms.decode_ems_serial,
          "tmm": cuda_nbms.decode_tmm_serial,
          "layered_tmm": cuda_nbms.decode_layered_tmm_serial}


def _llr(code, ebn0, batch, seed, device, n_qam=2):
    """Symbol LLRs of the all-zero codeword over BPSK or QAM + AWGN."""
    sigma = channel.sigma_from_snr(ebn0, code.rate, "ebn0",
                                   float(np.log2(n_qam)))
    labels = np.zeros(code.bit_length if n_qam == 2 else code.n_sym,
                      dtype=np.int64)
    g = torch.Generator(device=device).manual_seed(seed)
    return demod.nb_channel_llr(g, labels, constellation(n_qam), sigma,
                                batch, code.q, device=device)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' small CPU tensors gain nothing from torch's
    thread pool, whose spinning threads slow the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------- CPU side

@pytest.mark.parametrize("method", list(METHODS))
def test_wrapper_takes_the_plain_version_on_cpu(method):
    """A CPU tensor goes to the plain version, with no launch counted; a
    tensor on another device is refused."""
    code = NBCode.from_registry("LDPC_N96_K48_GF256_d1_exp")
    L = _llr(code, 4.0, 3, 1, torch.device("cpu"))
    kernel, plain = METHODS[method]
    before = dict(cuda_nbms.LAUNCHES)
    for a, b in zip(kernel(L, code, 4), plain(L, code, 4)):
        assert torch.equal(a, b)
    assert cuda_nbms.LAUNCHES == before
    with pytest.raises(ValueError, match="device"):
        kernel(torch.empty((1, code.n_sym, code.q), device="meta"), code, 3)


def test_what_the_kernel_takes():
    """The adjacency codes with full rows and q from 32 to 256, EMS at
    Nm = Nc = 2 only; a block's shared memory holds the totals and each
    row group's scratch, the c2v messages live in device memory.  On BDS
    flooding blocks hold 4 row groups of 4 warps: 3 blocks an SM by
    registers, 12 groups an SM, as many as 2 or 3 groups give; layered TMM
    runs one group."""
    for name in ("BDS.576.288.GF.64", "LDPC_N576_K288_GF64_d1_exp",
                 "LDPC_N96_K48_GF256_d1_exp", "LDPC_N576_K480_GF256_exp"):
        assert cuda_nbms.supports(NBCode.from_registry(name))
    bds = NBCode.from_registry("BDS.576.288.GF.64")
    plan = cuda_nbms.make_plan(bds)
    assert cuda_nbms.groups(plan, "ems") == cuda_nbms.groups(plan, "tmm") == 4
    assert cuda_nbms.groups(plan, "layered_tmm") == 1
    assert cuda_nbms.smem_bytes(plan, 4) == 4 * (
        96 * 64 + 4 * (2 * 4 * 64 + 7 * 64 + 96) + 64 + 126 + 96)
    assert cuda_nbms.smem_bytes(plan) == 4 * (
        96 * 64 + 2 * 4 * 64 + 7 * 64 + 96 + 64 + 126 + 96)
    assert not cuda_nbms.supports(bds, nm=3)
    assert not cuda_nbms.supports(bds, nc=3)
    assert not cuda_nbms.supports(NBCode.from_registry(
        "Tanner_74_9_Z128_GF16"))                  # q = 16, rows of 20/21


# --------------------------------------------------------------- card side

K8_CASES = [
    # code, Eb/N0, batch, iterations, QAM order
    ("BDS.576.288.GF.64", 2.0, 64, 20, 2),
    ("BDS.576.288.GF.64", 4.0, 37, 20, 2),
    ("BDS.576.288.GF.64", 0.0, 16, 1, 2),
    ("BDS.576.288.GF.64", 2.0, 16, 0, 2),
    ("BDS.576.288.GF.64", 10.0, 32, 10, 64),
    ("LDPC_N576_K288_GF64_d1_exp", 3.0, 32, 20, 2),
    ("LDPC_N96_K48_GF256_d1_exp", 3.0, 64, 20, 2),
    ("LDPC_N576_K480_GF256_exp", 4.0, 16, 10, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("name,ebn0,batch,iters,n_qam", K8_CASES,
                         ids=[f"{c[0]}-{c[4]}qam-it{c[3]}-B{c[2]}"
                              for c in K8_CASES])
def test_k8_matches_plain_on_card(cuda, method, name, ebn0, batch, iters,
                                  n_qam):
    code = NBCode.from_registry(name)
    L = _llr(code, ebn0, batch, batch + iters, cuda, n_qam)
    kernel, plain = METHODS[method]
    before = cuda_nbms.LAUNCHES[f"nbms_{method}"]
    a, b = kernel(L, code, iters), plain(L, code, iters)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y.cpu())
    assert cuda_nbms.LAUNCHES[f"nbms_{method}"] == before + (iters > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("name,ebn0,batch,iters,n_qam", K8_CASES,
                         ids=[f"{c[0]}-{c[4]}qam-it{c[3]}-B{c[2]}"
                              for c in K8_CASES])
def test_k8_row_groups_equal_the_serial_design(cuda, method, name, ebn0,
                                               batch, iters, n_qam):
    """The row groups (flooding: every row of a pass at once; layered TMM:
    by dependency level) against the serial design, one row at a time:
    hard, ok and iters bit for bit."""
    code = NBCode.from_registry(name)
    L = _llr(code, ebn0, batch, batch + iters + 1, cuda, n_qam)
    before = cuda_nbms.LAUNCHES[f"nbms_serial_{method}"]
    a = METHODS[method][0](L, code, iters)
    s = SERIAL[method](L, code, iters)
    torch.cuda.synchronize()
    for x, y in zip(a, s):
        assert torch.equal(x, y)
    assert cuda_nbms.LAUNCHES[f"nbms_serial_{method}"] == before + (iters > 0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    code = NBCode.from_registry("BDS.576.288.GF.64")
    L = _llr(code, 2.0, 4, 0, cuda)
    with pytest.raises(TypeError, match="float32"):
        cuda_nbms.decode_ems(L.double(), code, 2)
    with pytest.raises(ValueError, match=r"\[B, 96, 64\]"):
        cuda_nbms.decode_tmm(L[:, :90].contiguous(), code, 2)
    with pytest.raises(ValueError, match="does not take"):
        cuda_nbms.decode_ems(L, NBCode.from_registry("Tanner_74_9_Z128_GF16"),
                             2)
    empty = cuda_nbms.decode_layered_tmm(L[:0], code, 5)
    assert empty.hard.shape == (0, 96) and empty.hard.is_cuda
