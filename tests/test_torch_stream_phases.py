"""The K4 phase-timing tool (cuda_ldpc_torch.tools.stream_phases) on the
CPU: its counters land in the on-chip kernel's source, and it refuses to
run without a card (its measurements exist only there)."""

import re

import pytest
import torch

from cuda_ldpc_torch.ops import _build
from cuda_ldpc_torch.tools import stream_phases


def test_counters_land_at_every_phase_boundary():
    src = (_build.CSRC_DIR / "minsum_stream.cu").read_text()
    out = stream_phases.patched_source(src)
    marks = [int(m) for m in re.findall(r"PHASE_CLK\((\d+)\)\n", out)]
    assert sorted(marks) == sorted(stream_phases.PHASES)
    # each after the one before it in the kernel's text, inside onchip_kernel
    start = out.index("onchip_kernel(float* chan")
    at = [out.index(f"PHASE_CLK({i})\n") for i in sorted(marks)]
    assert all(a > start for a in at) and at == sorted(at)
    assert 'extern "C" int ldpc_phase_clocks' in out


def test_a_changed_kernel_is_refused():
    with pytest.raises(ValueError, match="anchor"):
        stream_phases.patched_source("// no kernel here\n")


def test_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("runs the measurement on a card")
    assert stream_phases.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err

