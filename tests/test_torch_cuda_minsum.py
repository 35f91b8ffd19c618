"""The CUDA decoders (cuda_ldpc_torch.ops.cuda_minsum: flooding K1, layered
K2, each with the min-sum rule or the bp rule K3) against their plain
PyTorch versions.  Tolerance: none — both do the same fp32 adds, compares
and multiplies in the same order, and for bp the kernel's logf/tanhf agree
with torch.log/torch.tanh on the card to the last bit, so hard, ok and iters
must be exactly equal.

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


def _code(name):
    return TINY if name == "tiny" else QCBinaryCode.from_registry(name)


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
            a = getattr(cuda_minsum, f"decode_{schedule}")(
                chan, code, 8, check="syndrome", rule=rule)
            b = getattr(minsum, f"decode_{schedule}")(
                chan, code, 8, check="syndrome", rule=rule)
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
    assert [p.name for p in _build.sources()] == ["minsum_flooding.cu",
                                                  "minsum_layered.cu"]
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
    assert sum(" -c " in ln for ln in log.splitlines()) == 2
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
