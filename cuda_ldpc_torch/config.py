"""Runtime configuration dataclasses of the binary simulator (counterpart of
cuda_ldpc_tpu/config.py:17-114, with the same fields and defaults; the GF(q)
dataclasses come with the GF(q) slice).

The reference bakes every parameter in at compile time as #define macros
(bldpc_实习/define.cuh:20-61) — changing the code under test means editing a
header and recompiling.  These dataclasses map 1:1 to those macros so every
shipped configuration is expressible at runtime (see each field's citation).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SweepConfig:
    """SNR sweep + stop rule.

    snr_start/step/stop: define.cuh:48-50 (binary: 0:0.2:13 Es/N0).
    snr_type: snrtype macro (0=ebn0, 1=esn0).  least_*: the stop rule
    'errors >= least_error_frames AND frames >= least_test_frames'
    (define.cuh:52-53).  display_step: progress-row frequency
    (define.cuh:54)."""
    snr_start: float = 0.0
    snr_step: float = 0.5
    snr_stop: float = 5.0
    snr_type: str = "ebn0"            # 'ebn0' | 'esn0'
    least_error_frames: int = 50
    least_test_frames: int = 1000
    max_frames: int = 10_000_000      # hard cap the reference lacks
    display_step: int = 10000
    seed: int = 173                   # ix/iy/iz_define collapse to one PRNG seed
    # seconds between mid-point state checkpoints of the stream engines
    # (not ported yet; kept so that a config means the same in both packages)
    stream_ckpt_s: float = 60.0

    def snr_points(self) -> list[float]:
        pts = []
        s = self.snr_start
        # float accumulation like the reference's `for (SNR += step)` loop
        while s <= self.snr_stop + 1e-9:
            pts.append(round(s, 6))
            s += self.snr_step
        return pts


@dataclasses.dataclass
class BinaryDecoderConfig:
    """Binary min-sum decoder (bldpc_实习).

    max_iters: maxIT (define.cuh:35).  alpha/beta: normalized/offset min-sum —
    the reference applies NO factor (opt_R commented out, define.cuh:36), so
    alpha=1, beta=0 reproduces it.  check: 'zero' is the reference's
    all-zero-message early stop (LDPC_Decoder.cu:137-153, Message_CW=0),
    'syndrome' the true parity check.  schedule: 'flooding' (the reference's
    only schedule) or 'layered'.  rule: 'minsum' (decoder_method=0, the
    reference's only implemented decoder) or 'bp' (exact sum-product —
    decoder_method=1, declared in define.cuh:33-34 but unimplemented there;
    the sim scales the channel to true LLRs 2y/sigma^2 for it)."""
    max_iters: int = 50
    alpha: float = 1.0
    beta: float = 0.0
    rule: str = "minsum"              # 'minsum' | 'bp'
    schedule: str = "flooding"        # 'flooding' | 'layered'
    check: str = "zero"               # 'zero' | 'syndrome' | 'none'
    message_only: bool = True         # Message_CW=0 (define.cuh:61)
    kernel: str = "auto"              # 'auto' | 'torch' | 'cuda'
    msg_dtype: str = "float32"


@dataclasses.dataclass
class BinarySimConfig:
    code: str = "J4_L24_Z96"          # BlockH registry name (define.cuh dims)
    decoder: BinaryDecoderConfig = dataclasses.field(
        default_factory=BinaryDecoderConfig)
    sweep: SweepConfig = dataclasses.field(default_factory=lambda: SweepConfig(
        snr_start=0.0, snr_step=0.2, snr_stop=13.0, snr_type="esn0",
        least_error_frames=50, least_test_frames=10000))
    batch_per_device: int = 4096      # Num_Frames_OneTime (define.cuh:60)
    add_noise: bool = True            # Add_noise (define.cuh:44)
    tx: str = "zero"                  # 'zero' (the reference's only mode) or
                                      # 'random' (real encoder + syndrome check)
    channel: str = "jax"              # 'jax' or 'device' (the device
                                      # generator; 'jax' is the JAX package's
                                      # name for it) or 'reference' (the CUDA
                                      # reference's exact host LCG noise
                                      # sequence, seeds reset per SNR point
                                      # like bldpc_实习/main.cu:117-119)
    # engine: 'batch' decodes whole batches until every frame converges (the
    # reference's host loop, bldpc_实习/LDPC_Decoder.cu:94-156); 'stream' is
    # the continuous-batching engine (not ported yet).
    engine: str = "batch"             # 'batch' | 'stream'
    stream_steps: int = 16            # decoder iterations per streaming call
