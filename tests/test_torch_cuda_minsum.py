"""The CUDA decoders (cuda_ldpc_torch.ops.cuda_minsum: flooding K1, layered
K2, each with the min-sum rule or the bp rule K3, each with float32 or
bfloat16 storage of T and R) against their plain PyTorch versions.
Tolerance: none — both do the same fp32 adds, compares and multiplies in
the same order and round to bfloat16 at the same points, and for bp the
kernel's logf/tanhf agree with torch.log/torch.tanh on the card to the
last bit, so hard, ok and iters must be exactly equal.

The kernel cases need a card and skip without one.  The file imports only
the port, so on a machine with a card and no JAX it runs on its own:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_minsum.py
"""

import stat

import numpy as np
import pytest
import torch

from cuda_ldpc_torch import QCBinaryCode
from cuda_ldpc_torch.ops import _build, channel, cuda_minsum, minsum

TINY = QCBinaryCode(name="tiny", base=np.array([[0, 1, 2, -1],
                                                [3, -1, 0, 1]]), Z=4)


# rows of 40 edges: the bp check node's largest degree bucket (33-64)
DEG40 = QCBinaryCode(name="deg40", base=np.arange(80).reshape(2, 40) % 16,
                     Z=16)


def _code(name):
    return {"tiny": TINY, "deg40": DEG40}.get(name) or \
        QCBinaryCode.from_registry(name)


def _chan(code, sigma, batch, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return channel.bpsk_awgn_llr(g, torch.zeros(code.L, code.Z), sigma,
                                 batch).to(device)


def _assert_same(a, b):
    assert torch.equal(a.hard.cpu(), b.hard.cpu())
    assert torch.equal(a.ok.cpu(), b.ok.cpu())
    assert int(a.iters) == int(b.iters)


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------- CPU side

def test_cpu_tensor_takes_the_plain_version():
    code = _code("J4_L24_Z96")
    chan = _chan(code, 0.5, 5, seed=1)
    before = dict(cuda_minsum.LAUNCHES)
    for schedule in ("flooding", "layered"):
        for rule in ("minsum", "bp"):
            for dtype in (None, torch.bfloat16):
                a = getattr(cuda_minsum, f"decode_{schedule}")(
                    chan, code, 8, check="syndrome", rule=rule,
                    msg_dtype=dtype)
                b = getattr(minsum, f"decode_{schedule}")(
                    chan, code, 8, check="syndrome", rule=rule,
                    msg_dtype=dtype)
                _assert_same(a, b)
    assert cuda_minsum.LAUNCHES == before       # counted only on launch


@pytest.mark.parametrize("name", ["tiny", "J4_L24_Z96", "PON_LDPC"])
def test_edge_tables_follow_the_code(name):
    code = _code(name)
    t = cuda_minsum.edge_tables(code, torch.device("cpu"))
    assert all(x.dtype == torch.int32 for x in t)
    np.testing.assert_array_equal(t.edge_l.numpy(), code.edges[:, 1])
    np.testing.assert_array_equal(t.edge_s.numpy(), code.edges[:, 2])
    for ptr, lst, groups in [(t.row_ptr, t.row_edge, code.row_edges),
                             (t.col_ptr, t.col_edge, code.col_edges)]:
        ptr = ptr.numpy()
        assert ptr[0] == 0 and ptr[-1] == code.num_edges
        for g, want in enumerate(groups):
            np.testing.assert_array_equal(lst.numpy()[ptr[g]:ptr[g + 1]], want)


def test_build_targets_sm90a_without_fast_math():
    src = _build.sources()[0]
    cmd = _build.compile_command(src, _build.BUILD_DIR / "x.o")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "--use_fast_math" not in cmd and "-c" in cmd
    assert "-shared" in _build.link_command([], _build.BUILD_DIR / "x.so")
    assert [p.name for p in _build.sources()] == [
        "minsum_flooding.cu", "minsum_layered.cu", "minsum_stream.cu",
        "nbms.cu", "probe_bitops.cu", "probe_mosaic.cu", "probe_oprate.cu",
        "qspa.cu", "qspa_qc.cu", "qspa_stream.cu"]
    assert _build.lib_path().parent.parent == _build.BUILD_DIR
    assert len(_build.source_hash()) == 16


@pytest.mark.parametrize("fail", [False, True])
def test_build_compiles_each_source_then_links(tmp_path, monkeypatch, fail):
    """One compiler process per source, then one link, with every command
    and its output in build.log; a failed compile raises with that log and
    leaves no library.  The compiler is a stand-in script that writes the
    file named after -o."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    + ('case "$*" in *layered*) echo broken; exit 3;; esac\n'
                       if fail else "")
                    + 'while [ "$1" != -o ]; do shift; done; '
                      'echo built > "$2"; echo "ptxas info: $2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if fail:
        with pytest.raises(RuntimeError, match="broken"):
            _build.build()
        assert not _build.lib_path().exists()
    else:
        assert _build.build() == _build.lib_path()
        assert _build.lib_path().read_text() == "built\n"
    log = (_build.lib_path().parent / "build.log").read_text()
    assert sum(" -c " in ln for ln in log.splitlines()) == \
        len(_build.sources())
    assert ("-shared" in log) != fail
    assert not [p for p in _build.lib_path().parent.iterdir()
                if p.suffix in (".o", ".tmp")]


# --------------------------------------------------------------- card side

KERNEL_CASES = [
    # code, sigma, batch, iters, check, early stop, alpha, beta
    ("J4_L24_Z96", 0.50, 64, 20, "zero", True, 1.0, 0.0),
    ("J4_L24_Z96", 0.50, 64, 20, "syndrome", True, 1.0, 0.0),
    ("J4_L24_Z96", 0.55, 64, 8, "none", True, 1.0, 0.0),
    ("J4_L24_Z96", 0.55, 11, 10, "zero", False, 0.8, 0.1),
    ("J4_L24_Z256", 0.50, 32, 12, "syndrome", False, 0.8, 0.1),
    ("J4_L24_Z256", 0.45, 32, 20, "zero", True, 1.0, 0.0),
    ("tiny", 0.50, 11, 10, "syndrome", True, 1.0, 0.0),
    ("J15_L30_Z1280", 0.75, 16, 30, "zero", True, 1.0, 0.0),
    ("PON_LDPC", 0.72, 16, 30, "syndrome", True, 1.0, 0.0),
    ("J4_L24_Z96", 0.50, 11, 0, "zero", True, 1.0, 0.0),
    ("tiny", 0.50, 0, 5, "zero", False, 1.0, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,sigma,batch,iters,check,early,alpha,beta",
                         KERNEL_CASES,
                         ids=[f"{c[0]}-{c[4]}-early{int(c[5])}-a{c[6]}b{c[7]}"
                              f"-it{c[3]}-B{c[2]}" for c in KERNEL_CASES])
def test_kernel_matches_plain_on_card(cuda, name, sigma, batch, iters, check,
                                      early, alpha, beta):
    code = _code(name)
    chan = _chan(code, sigma, batch, seed=batch + iters, device=cuda)
    before = cuda_minsum.LAUNCHES["minsum_flooding"]
    a = cuda_minsum.decode_flooding(chan, code, iters, alpha=alpha, beta=beta,
                                    check=check, early_stop=early)
    b = minsum.decode_flooding(chan, code, iters, alpha=alpha, beta=beta,
                               check=check, early_stop=early)
    torch.cuda.synchronize()
    _assert_same(a, b)
    assert a.hard.dtype == torch.int8 and a.ok.dtype == torch.bool
    assert a.iters.dtype == torch.int32
    assert cuda_minsum.LAUNCHES["minsum_flooding"] == \
        before + (iters > 0 and batch > 0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    code = _code("J4_L24_Z96")
    chan = _chan(code, 0.5, 4, seed=0, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        cuda_minsum.decode_flooding(chan.double(), code, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_minsum.decode_flooding(
            chan.transpose(0, 1).contiguous().transpose(0, 1), code, 2)
    with pytest.raises(ValueError, match=r"\[B, 24, 96\]"):
        cuda_minsum.decode_flooding(chan[:, :20].contiguous(), code, 2)
    with pytest.raises(ValueError, match="check"):
        cuda_minsum.decode_flooding(chan, code, 2, check="parity")


# schedule, rule, code, sigma, batch, iters, check, early stop, alpha, beta
RULE_CASES = [
    ("layered", "minsum", "J4_L24_Z96", 0.50, 64, 20, "zero", True, 1.0, 0.0),
    ("layered", "minsum", "J4_L24_Z96", 0.55, 11, 10, "syndrome", False, 0.8,
     0.1),
    ("layered", "minsum", "tiny", 0.50, 11, 10, "none", True, 1.0, 0.0),
    ("layered", "minsum", "J15_L30_Z1280", 0.75, 16, 30, "zero", True, 1.0,
     0.0),
    ("layered", "minsum", "PON_LDPC", 0.72, 16, 30, "syndrome", True, 1.0,
     0.0),
    ("layered", "minsum", "J4_L24_Z96", 0.50, 11, 0, "zero", True, 1.0, 0.0),
    ("flooding", "bp", "J4_L24_Z96", 0.60, 64, 20, "zero", True, 1.0, 0.0),
    ("flooding", "bp", "PON_LDPC", 0.72, 16, 20, "syndrome", False, 0.8, 0.1),
    ("layered", "bp", "J4_L24_Z96", 0.60, 64, 20, "syndrome", True, 1.0, 0.0),
    ("layered", "bp", "J15_L30_Z1280", 0.75, 16, 20, "zero", True, 1.0, 0.0),
    # the bp check node's degree buckets: 8 (J15), 32 (PON, 22-23), 64
    ("flooding", "bp", "J15_L30_Z1280", 0.75, 16, 20, "syndrome", False, 0.8,
     0.1),
    ("layered", "bp", "PON_LDPC", 0.72, 16, 20, "zero", True, 0.8, 0.1),
    ("flooding", "bp", "deg40", 0.45, 32, 10, "syndrome", False, 1.0, 0.0),
    ("layered", "bp", "deg40", 0.45, 32, 10, "none", True, 0.8, 0.1),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "schedule,rule,name,sigma,batch,iters,check,early,alpha,beta", RULE_CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[6]}-early{int(c[7])}-a{c[8]}b{c[9]}"
         f"-it{c[5]}-B{c[4]}" for c in RULE_CASES])
def test_layered_and_bp_kernels_match_plain_on_card(
        cuda, schedule, rule, name, sigma, batch, iters, check, early, alpha,
        beta):
    code = _code(name)
    chan = _chan(code, sigma, batch, seed=batch + iters, device=cuda)
    if rule == "bp":
        chan = chan * (2.0 / sigma**2)
    key = f"{rule}_{schedule}"
    before = cuda_minsum.LAUNCHES[key]
    kw = dict(alpha=alpha, beta=beta, check=check, early_stop=early,
              rule=rule)
    a = getattr(cuda_minsum, f"decode_{schedule}")(chan, code, iters, **kw)
    b = getattr(minsum, f"decode_{schedule}")(chan, code, iters, **kw)
    torch.cuda.synchronize()
    _assert_same(a, b)
    assert cuda_minsum.LAUNCHES[key] == before + (iters > 0)


def passes_then_fails() -> np.ndarray:
    """Two J4_L24_Z96 frames whose batch needs the on-chip stop protocol's
    lockstep steps (csrc/onchip.cuh).  The first is crafted: its message
    columns positive, so that the zero check passes early, its parity
    columns negative, so that the check nodes pull message bits negative
    later.  It passes the zero check at iterations 1 and 2 (flooding; at 2
    and 4 layered) and fails from 3 on.  The second, a noisy frame (sigma
    0.5), first passes at 7 (layered: 3), where the first fails."""
    code = _code("J4_L24_Z96")
    rng = np.random.default_rng(2)
    m = code.L - code.J
    a = np.empty((1, code.L, code.Z), np.float32)
    a[0, :m] = 2.0 * (0.5 + 0.5 * rng.random((m, code.Z)))
    a[0, m:] = -1.0
    noisy = 1.0 + 0.5 * np.random.default_rng(5).standard_normal(
        (16, code.L, code.Z))
    return np.concatenate([a, noisy[:1].astype(np.float32)])


# schedule, code, sigma, batch, iters, check, early stop, alpha, beta; a
# sigma of None is passes_then_fails() tiled to the batch
ONCHIP_CASES = [
    ("flooding", "J4_L24_Z96", 0.52, 37, 30, "zero", True, 1.0, 0.0),
    ("layered", "J4_L24_Z96", 0.52, 37, 30, "syndrome", True, 0.8, 0.1),
    ("flooding", "J4_L24_Z96", 0.53, 4096, 30, "syndrome", True, 0.8, 0.1),
    ("layered", "J4_L24_Z96", 0.53, 4096, 30, "zero", True, 1.0, 0.0),
    ("flooding", "J4_L24_Z96", 0.55, 4096, 12, "none", True, 1.0, 0.0),
    ("layered", "J4_L24_Z96", 0.55, 4096, 12, "zero", False, 0.8, 0.1),
    ("flooding", "J4_L24_Z96", None, 4096, 20, "zero", True, 1.0, 0.0),
    ("layered", "J4_L24_Z96", None, 37, 20, "zero", True, 1.0, 0.0),
    ("flooding", "PON_LDPC", 0.72, 4096, 30, "syndrome", True, 1.0, 0.0),
    ("layered", "PON_LDPC", 0.72, 4096, 30, "zero", True, 0.8, 0.1),
    ("flooding", "J15_L30_Z1280", 0.78, 4096, 10, "zero", True, 1.0, 0.0),
    ("layered", "J15_L30_Z1280", 0.78, 4096, 10, "syndrome", False, 0.8,
     0.1),
    ("flooding", "deg40", 0.45, 37, 10, "syndrome", True, 1.0, 0.0),
    ("layered", "deg40", 0.45, 37, 10, "zero", True, 0.8, 0.1),
]


def _chan_of(code, sigma, batch, iters, device):
    """The case's channel: AWGN at ``sigma``, or, for a sigma of None,
    passes_then_fails() tiled to the batch."""
    if sigma is None:
        two = torch.from_numpy(passes_then_fails())
        return two.repeat((batch + 1) // 2, 1, 1)[:batch].contiguous().to(
            device)
    return _chan(code, sigma, batch, seed=batch + iters, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "schedule,name,sigma,batch,iters,check,early,alpha,beta", ONCHIP_CASES,
    ids=[f"{c[0]}-{c[1]}-{c[5]}-early{int(c[6])}-a{c[7]}b{c[8]}-s{c[2]}"
         f"-B{c[3]}" for c in ONCHIP_CASES])
def test_onchip_minsum_matches_plain_on_card(
        cuda, schedule, name, sigma, batch, iters, check, early, alpha,
        beta):
    code = _code(name)
    chan = _chan_of(code, sigma, batch, iters, cuda)
    key = f"minsum_{schedule}"
    before = cuda_minsum.LAUNCHES[key]
    kw = dict(alpha=alpha, beta=beta, check=check, early_stop=early)
    a = getattr(cuda_minsum, f"decode_{schedule}")(chan, code, iters, **kw)
    b = getattr(minsum, f"decode_{schedule}")(chan, code, iters, **kw)
    torch.cuda.synchronize()
    _assert_same(a, b)
    assert cuda_minsum.LAUNCHES[key] == before + 1


# rule, schedule, code, sigma, batch, iters, check, early stop, alpha, beta;
# a sigma of None is passes_then_fails() tiled to the batch
BF16_CASES = [
    ("minsum", "flooding", "J4_L24_Z96", 0.52, 37, 30, "zero", True, 1.0,
     0.0),
    ("minsum", "layered", "J4_L24_Z96", 0.52, 37, 30, "syndrome", True, 0.8,
     0.1),
    ("minsum", "flooding", "J4_L24_Z96", None, 4096, 20, "zero", True, 1.0,
     0.0),
    ("minsum", "layered", "J4_L24_Z96", None, 37, 20, "zero", True, 1.0,
     0.0),
    ("minsum", "flooding", "J4_L24_Z96", 0.55, 4096, 12, "none", True, 0.8,
     0.1),
    ("minsum", "layered", "J4_L24_Z96", 0.55, 4096, 12, "zero", False, 1.0,
     0.0),
    ("minsum", "flooding", "PON_LDPC", 0.72, 4096, 30, "syndrome", True, 0.8,
     0.1),
    ("minsum", "layered", "PON_LDPC", 0.72, 4096, 30, "zero", True, 1.0,
     0.0),
    ("minsum", "flooding", "J15_L30_Z1280", 0.78, 512, 10, "zero", True,
     1.0, 0.0),
    ("minsum", "layered", "J15_L30_Z1280", 0.78, 512, 10, "syndrome", False,
     0.8, 0.1),
    ("minsum", "flooding", "deg40", 0.45, 37, 10, "syndrome", True, 1.0,
     0.0),
    ("minsum", "layered", "deg40", 0.45, 37, 10, "zero", True, 0.8, 0.1),
    ("bp", "flooding", "J4_L24_Z96", 0.60, 64, 20, "zero", True, 1.0, 0.0),
    ("bp", "layered", "J4_L24_Z96", 0.60, 64, 20, "syndrome", True, 0.8,
     0.1),
    ("bp", "flooding", "J15_L30_Z1280", 0.75, 16, 20, "syndrome", False, 1.0,
     0.0),
    ("bp", "layered", "PON_LDPC", 0.72, 16, 20, "zero", True, 0.8, 0.1),
    ("bp", "flooding", "deg40", 0.45, 32, 10, "none", True, 1.0, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rule,schedule,name,sigma,batch,iters,check,early,alpha,beta", BF16_CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[6]}-early{int(c[7])}-a{c[8]}b{c[9]}"
         f"-s{c[3]}-B{c[4]}" for c in BF16_CASES])
def test_bf16_kernels_match_plain_on_card(cuda, rule, schedule, name, sigma,
                                          batch, iters, check, early, alpha,
                                          beta):
    """K1, K2 and K3 with T and R stored in bfloat16 against the plain
    version's bf16 storage, counted under their own key."""
    code = _code(name)
    chan = _chan_of(code, sigma, batch, iters, cuda)
    if rule == "bp":
        chan = chan * (2.0 / sigma**2)
    key = f"{rule}_{schedule}_bf16"
    before = dict(cuda_minsum.LAUNCHES)
    kw = dict(alpha=alpha, beta=beta, check=check, early_stop=early,
              rule=rule, msg_dtype=torch.bfloat16)
    a = getattr(cuda_minsum, f"decode_{schedule}")(chan, code, iters, **kw)
    b = getattr(minsum, f"decode_{schedule}")(chan, code, iters, **kw)
    torch.cuda.synchronize()
    _assert_same(a, b)
    assert cuda_minsum.LAUNCHES == dict(before, **{key: before[key] + 1})


@pytest.mark.cuda
def test_onchip_minsum_refuses_a_code_no_plan_holds(cuda):
    rng = np.random.default_rng(0)
    base = np.where(rng.random((40, 80)) < 0.1,
                    rng.integers(0, 4096, (40, 80)), -1)
    big = QCBinaryCode(name="big", base=base, Z=4096)
    chan = torch.zeros((1, big.L, big.Z), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_minsum.decode_flooding(chan, big, 2)
