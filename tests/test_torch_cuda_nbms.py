"""The CUDA GF(q) max-domain decoder (cuda_ldpc_torch.ops.cuda_nbms, K8:
EMS Nm=2/Nc=2, EMS at other Nm/Nc, full EMS, TMM, layered TMM,
grouped-layered TMM, and the earlier designs of full EMS and EMS at Nm/Nc
kept as their yardstick) against its plain PyTorch version.  Tolerance:
none — the kernel does the plain version's fp32 operations in its order
(ops/nb_decode.py's docstring fixes them; max, min and the GF tables are
exact), so hard, ok and iters must be exactly equal.

The kernel cases need a card and skip without one.  The file imports only
the port, so on a machine with a card and no JAX it runs on its own:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_nbms.py
"""

import functools

import numpy as np
import pytest
import torch

from cuda_ldpc_torch import NBCode
from cuda_ldpc_torch.ops import channel, cuda_nbms, demod, nb_decode
from cuda_ldpc_torch.utils.constellations import constellation

def _ems(nm, nc, dense=False):
    """EMS at (nm, nc): the kernel's wrapper and the plain version, K8's
    mode ems_nmnc (``dense``: its earlier design, the yardstick)."""
    if dense:
        return (functools.partial(cuda_nbms.decode_ems_nmnc_dense, nm=nm,
                                  nc=nc),
                functools.partial(nb_decode.decode_ems, nm=nm, nc=nc),
                "nbms_ems_nmnc_dense")
    return (functools.partial(cuda_nbms.decode_ems, nm=nm, nc=nc),
            functools.partial(nb_decode.decode_ems, nm=nm, nc=nc),
            "nbms_ems_nmnc")


# name -> (wrapper, plain version, launch count)
METHODS = {"ems": (cuda_nbms.decode_ems, nb_decode.decode_ems, "nbms_ems"),
           "ems_full": (cuda_nbms.decode_ems_full,
                        functools.partial(nb_decode.decode_ems, full=True),
                        "nbms_ems_full"),
           "tmm": (cuda_nbms.decode_tmm, nb_decode.decode_tmm, "nbms_tmm"),
           "layered_tmm": (cuda_nbms.decode_layered_tmm,
                           nb_decode.decode_layered_tmm, "nbms_layered_tmm"),
           "glayered_tmm": (cuda_nbms.decode_glayered_tmm,
                            lambda L, code, iters: nb_decode.decode(
                                L, code, "glayered_tmm", iters),
                            "nbms_glayered_tmm"),
           # conf(q,1) only; the pairs; the chains (unbudgeted on dc = 4,
           # budgeted on LDPC_N576_K480_GF256_exp's dc = 12; listed
           # messages at 8/3, dense at 64/3)
           "ems_nm1_nc2": _ems(1, 2), "ems_nm3_nc2": _ems(3, 2),
           "ems_nm8_nc3": _ems(8, 3), "ems_nm64_nc3": _ems(64, 3),
           # the yardstick
           "ems_full_dense": (cuda_nbms.decode_ems_full_dense,
                              functools.partial(nb_decode.decode_ems,
                                                full=True),
                              "nbms_ems_full_dense"),
           "ems_nm8_nc3_dense": _ems(8, 3, dense=True)}


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
    kernel, plain, _ = METHODS[method]
    before = dict(cuda_nbms.LAUNCHES)
    for a, b in zip(kernel(L, code, 4), plain(L, code, 4)):
        assert torch.equal(a, b)
    assert cuda_nbms.LAUNCHES == before
    with pytest.raises(ValueError, match="device"):
        kernel(torch.empty((1, code.n_sym, code.q), device="meta"), code, 3)


def test_what_the_kernel_takes():
    """The adjacency codes with full rows and q from 32 to 256, EMS at
    every (Nm, Nc) the plain version takes (Nc >= 1; Nm - 1 <= q where
    the rows take an edge's top Nm - 1 offsets); a block's shared memory
    holds the totals and each row group's scratch, the c2v messages live
    in device memory.  On BDS flooding blocks (EMS at any Nm/Nc, full EMS,
    TMM) hold 4 row groups of 4 warps: 3 blocks an SM by registers, 12
    groups an SM, as many as 2 or 3 groups give; layered TMM runs one
    group, and so does grouped-layered TMM.  The budgeted chains of a row
    group keep their levels in the group's shared memory (20 vectors a
    chain at Nc = 10 on LDPC_N576_K480_GF256_exp, 36 at Nc = 6); the
    yardstick's keep [2, dc, Nc + 1, q] in device memory."""
    for name in ("BDS.576.288.GF.64", "LDPC_N576_K288_GF64_d1_exp",
                 "LDPC_N96_K48_GF256_d1_exp", "LDPC_N576_K480_GF256_exp"):
        assert cuda_nbms.supports(NBCode.from_registry(name))
    bds = NBCode.from_registry("BDS.576.288.GF.64")
    plan = cuda_nbms.make_plan(bds)
    assert cuda_nbms.groups(plan, "ems") == cuda_nbms.groups(plan, "tmm") == 4
    assert cuda_nbms.groups(plan, "ems_full") == 4
    assert cuda_nbms.groups(plan, "ems_nmnc") == 4
    assert cuda_nbms.groups(plan, "layered_tmm") == 1
    assert cuda_nbms.groups(plan, "glayered_tmm") == 1
    assert cuda_nbms.smem_bytes(plan, 4) == 4 * (
        96 * 64 + 4 * (2 * 4 * 64 + 7 * 64 + 96) + 64 + 126 + 96)
    assert cuda_nbms.smem_bytes(plan) == 4 * (
        96 * 64 + 2 * 4 * 64 + 7 * 64 + 96 + 64 + 126 + 96)
    for nm, nc in [(3, 2), (2, 3), (1, 2), (3, 1), (65, 2), (65, 3),
                   (66, 1), (0, 5)]:
        assert cuda_nbms.supports(bds, nm=nm, nc=nc)
    for nm, nc in [(66, 2), (66, 3), (2, 0)]:       # Nm - 1 > q; Nc < 1
        assert not cuda_nbms.supports(bds, nm=nm, nc=nc)
    k480 = NBCode.from_registry("LDPC_N576_K480_GF256_exp")
    assert cuda_nbms.supports(k480, nm=257, nc=10)
    assert not cuda_nbms.supports(k480, nm=258, nc=10)
    assert [cuda_nbms.ems_branch(nm, nc, 4) for nm, nc in
            [(1, 2), (3, 1), (2, 2), (64, 2), (8, 3), (64, 30)]] == [
                "conf1", "conf1", "pairs", "pairs", "chains", "chains"]
    assert [cuda_nbms.ems_branch(8, nc, 12) for nc in (2, 3, 10, 11)] == [
        "pairs", "budget", "budget", "chains"]
    k480_plan = cuda_nbms.make_plan(k480)
    assert [cuda_nbms.budget_levels(12, nc) for nc in range(3, 11)] == [
        27, 32, 35, 36, 35, 32, 27, 20]
    assert cuda_nbms.budget_floats(k480_plan, 10) == (1 + 2 * 20) * 256
    assert cuda_nbms.dense_budget_floats(k480_plan, 10) == 2 * 12 * 11 * 256
    assert cuda_nbms.smem_bytes(k480_plan, 1, cuda_nbms.group_budget(
        k480_plan, "ems_nmnc", 8, 6)) == 189_080
    assert cuda_nbms.group_budget(k480_plan, "ems_nmnc_dense", 8, 6) == 0
    assert not cuda_nbms.supports(NBCode.from_registry(
        "Tanner_74_9_Z128_GF16"))                  # q = 16, rows of 20/21


def _took_before(code, nm, nc):
    """supports() as it stood while the budgeted chains lived in device
    memory: the shared memory of a block without any budget region."""
    try:
        nb_decode.check_ems(nm, nc, code.q, code.max_dc)
    except ValueError:
        return False
    plan = cuda_nbms.make_plan(code)
    return (not code.q & (code.q - 1) and 32 <= code.q <= 256
            and bool(code.cn_mask.all()) and 2 <= plan.max_dc <= 32
            and cuda_nbms.smem_bytes(plan) <= cuda_nbms.SMEM_LIMIT)


@pytest.mark.parametrize("name", ["BDS.576.288.GF.64",
                                  "LDPC_N576_K288_GF64_d1_exp",
                                  "LDPC_N96_K48_GF256_d1_exp",
                                  "LDPC_N576_K480_GF256_exp",
                                  "Tanner_74_9_Z128_GF16"])
def test_supports_takes_what_it_took_with_the_budget_in_device_memory(name):
    """The budget region in shared memory (156-189 KB blocks on
    LDPC_N576_K480_GF256_exp at Nc 3 to 10) leaves supports() taking every
    (code, Nm, Nc) it took before and nothing else, on each registry
    adjacency code and on the Tanner code it refuses."""
    code = NBCode.from_registry(name)
    for nm in (0, 1, 2, 3, 8, 16, 64, 65, 66, 100, 256, 257, 258):
        for nc in range(0, 14):
            assert cuda_nbms.supports(code, nm=nm, nc=nc) == _took_before(
                code, nm, nc), (nm, nc)


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
    kernel, plain, key = METHODS[method]
    before = cuda_nbms.LAUNCHES[key]
    a, b = kernel(L, code, iters), plain(L, code, iters)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y.cpu())
    assert cuda_nbms.LAUNCHES[key] == before + (iters > 0)


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
    with pytest.raises(ValueError, match="Nm - 1 <= q"):
        cuda_nbms.decode_ems(L, code, 2, nm=66, nc=2)
    empty = cuda_nbms.decode_layered_tmm(L[:0], code, 5)
    assert empty.hard.shape == (0, 96) and empty.hard.is_cuda
