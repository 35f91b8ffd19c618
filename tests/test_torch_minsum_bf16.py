"""bfloat16 message storage (``msg_dtype=torch.bfloat16``) in the port's
plain binary decoders, held against the JAX package's TPU kernels
``pallas_minsum.decode_flooding`` and ``decode_layered`` with
``msg_dtype=jnp.bfloat16``, run in interpret mode as their own tests run
them on the CPU, on the same numpy LLRs; and ``--msg-dtype bfloat16``
through the CLI (the bench's ``BENCH_DTYPE=bfloat16`` line is in
tests/test_torch_bench.py).

The kernel stores T and R in bf16 and computes in float32; so does the
port (ops/minsum.py's module docstring gives the rounding points).
Tolerance: none for min-sum (hard, ok and iters exactly equal); for bp,
whose log/tanh come from another library on each side, ok and iters
exactly and hard on every frame whose check passed (the bp cases use
the syndrome check at a noise where at least half the frames pass, and
assert that they do).  B = 8 is one tile of
the kernel, whose early stop is per tile, so its stop is the batch's.
Each case also asserts that float32 storage decodes otherwise, so that an
exact match cannot be float32 parity.  The code is a small synthetic one
(a 3 x 6 base at Z = 64), cheap to interpret.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu import QCBinaryCode as JaxCode
from cuda_ldpc_tpu.ops import pallas_minsum
from cuda_ldpc_torch import QCBinaryCode, cli, sim
from cuda_ldpc_torch import config as cfg
from cuda_ldpc_torch.ops import cuda_minsum, minsum

_RNG = np.random.default_rng(0)
BASE = _RNG.integers(0, 64, (3, 6))
BASE[0, 5] = BASE[2, 0] = -1
JAX_CODE = JaxCode(name="syn3x6", base=BASE, Z=64)
CODE = QCBinaryCode(name="syn3x6", base=BASE, Z=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from torch's thread pool, and its
    spinning threads slow the other test workers sharing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _llrs(sigma, seed, rule):
    """All-zero codeword through BPSK + AWGN, made with numpy; true LLRs
    2y/sigma^2 for bp."""
    y = (1.0 + sigma * np.random.default_rng(seed).standard_normal(
        (8, CODE.L, CODE.Z))).astype(np.float32)
    return y * np.float32(2.0 / sigma**2) if rule == "bp" else y


# schedule, rule, sigma, seed, iters, check, early stop, alpha, beta
CASES = [
    ("flooding", "minsum", 1.4, 1, 12, "none", True, 0.8, 0.0),
    ("layered", "minsum", 1.4, 1, 12, "none", True, 0.8, 0.0),
    ("flooding", "minsum", 0.9, 5, 12, "syndrome", True, 0.8, 0.1),
    ("layered", "minsum", 0.9, 4, 12, "zero", True, 1.0, 0.0),
    ("flooding", "bp", 0.8, 5, 12, "syndrome", True, 1.0, 0.0),
    ("layered", "bp", 0.8, 12, 12, "syndrome", True, 1.0, 0.0),
]


@pytest.mark.parametrize(
    "schedule,rule,sigma,seed,iters,check,early,alpha,beta", CASES,
    ids=[f"{c[0]}-{c[1]}-{c[5]}-s{c[2]}-a{c[7]}b{c[8]}" for c in CASES])
def test_bf16_plain_matches_the_tpu_kernel(schedule, rule, sigma, seed,
                                           iters, check, early, alpha, beta):
    chan = _llrs(sigma, seed, rule)
    kw = dict(alpha=alpha, beta=beta, check=check, early_stop=early,
              rule=rule)
    a = getattr(pallas_minsum, f"decode_{schedule}")(
        jnp.asarray(chan), JAX_CODE, iters, msg_dtype=jnp.bfloat16,
        interpret=True, **kw)
    plain = getattr(minsum, f"decode_{schedule}")
    b = plain(torch.from_numpy(chan), CODE, iters, msg_dtype=torch.bfloat16,
              **kw)
    f = plain(torch.from_numpy(chan), CODE, iters, **kw)
    assert b.hard.dtype == torch.int8 and b.ok.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(a.ok), b.ok.numpy())
    assert int(a.iters) == int(b.iters)
    passed = b.ok.numpy() if rule == "bp" else np.ones(8, bool)
    assert passed.sum() >= 4        # bp's hard decisions are compared
    np.testing.assert_array_equal(np.asarray(a.hard)[passed],
                                  b.hard.numpy()[passed])
    # float32 storage decodes this input otherwise
    assert (f.hard != b.hard).any() or int(f.iters) != int(b.iters)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("rule", ["minsum", "bp"])
def test_float32_names_change_nothing(schedule, rule):
    """msg_dtype None, 'float32' and torch.float32 are one storage, and the
    wrapper on a CPU tensor is the plain version in either storage."""
    chan = torch.from_numpy(_llrs(0.9, 5, rule))
    plain = getattr(minsum, f"decode_{schedule}")
    wrap = getattr(cuda_minsum, f"decode_{schedule}")
    ref = plain(chan, CODE, 8, alpha=0.8, rule=rule)
    before = dict(cuda_minsum.LAUNCHES)
    for dtype in ("float32", torch.float32):
        got = plain(chan, CODE, 8, alpha=0.8, rule=rule, msg_dtype=dtype)
        assert torch.equal(got.hard, ref.hard) and torch.equal(got.ok, ref.ok)
    for dtype in (None, "bfloat16"):
        a = wrap(chan, CODE, 8, alpha=0.8, rule=rule, msg_dtype=dtype)
        b = plain(chan, CODE, 8, alpha=0.8, rule=rule, msg_dtype=dtype)
        assert torch.equal(a.hard, b.hard) and torch.equal(a.ok, b.ok)
        assert int(a.iters) == int(b.iters)
    assert cuda_minsum.LAUNCHES == before       # counted only on launch


@pytest.mark.parametrize("dtype", ["float16", torch.float64, "bf16"])
def test_unknown_msg_dtype_is_refused(dtype):
    chan = torch.zeros(1, CODE.L, CODE.Z)
    with pytest.raises(ValueError, match="msg_dtype"):
        minsum.decode_flooding(chan, CODE, 2, msg_dtype=dtype)
    with pytest.raises(ValueError, match="msg_dtype"):
        cuda_minsum.decode_layered(chan, CODE, 2, msg_dtype=dtype)


RUN = ["binary", "--device", "cpu", "--code", "J4_L24_Z96", "--batch", "16",
       "--max-iters", "8", "--snr", "3.6", "--snr-type", "ebn0",
       "--least-error-frames", "1", "--least-test-frames", "16",
       "--max-frames", "32", "--msg-dtype", "bfloat16", "--quiet"]


@pytest.mark.parametrize("argv", [
    [], ["--packed"], ["--channel", "reference"],
    ["--schedule", "layered", "--rule", "bp"],
    ["--packed", "--schedule", "layered", "--alpha", "0.8"],
    ["--rule", "bp", "--tx", "random", "--check", "syndrome"],
])
def test_cli_runs_bf16_on_cpu(tmp_path, argv, monkeypatch):
    """--msg-dtype bfloat16 reaches the decoder on the batch and packed
    engines and the reference channel (every call is the bf16 plain
    version)."""
    seen = []
    for name in ("decode_flooding", "decode_layered"):
        real = getattr(minsum, name)

        def spy(*a, _real=real, **kw):
            seen.append(kw.get("msg_dtype"))
            return _real(*a, **kw)
        monkeypatch.setattr(minsum, name, spy)
    out = tmp_path / "res"
    assert cli.main([*RUN, "--out-dir", str(out), *argv]) == 0
    assert (out / "results.jsonl").exists()
    assert seen and set(seen) == {"bfloat16"}


@pytest.mark.parametrize("argv", [["--engine", "stream"],
                                  ["--engine", "stream", "--packed",
                                   "--schedule", "layered"]])
def test_cli_refuses_bf16_on_the_stream_engine(tmp_path, argv, capsys):
    """A refusal by design, naming no ROADMAP item: the TPU stream kernel
    stores float32 and has no bf16 form."""
    out = tmp_path / "res"
    with pytest.raises(SystemExit) as exc:
        cli.main([*RUN, "--out-dir", str(out), *argv])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "stream engine stores float32" in err and "ROADMAP" not in err
    assert not out.exists()


def test_check_ported_takes_bf16_on_the_batch_engine():
    sim.check_ported(cfg.BinarySimConfig(decoder=cfg.BinaryDecoderConfig(
        msg_dtype="bfloat16")))
    with pytest.raises(ValueError, match="msg_dtype"):
        sim.check_ported(cfg.BinarySimConfig(
            decoder=cfg.BinaryDecoderConfig(msg_dtype="float16")))
