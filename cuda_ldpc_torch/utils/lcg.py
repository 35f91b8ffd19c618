"""Bit-faithful NumPy port of the reference's combined 3-seed LCG and
Box-Muller binary AWGN generator (counterpart of cuda_ldpc_tpu/utils/lcg.py:
21-55; the NB generator comes with the GF(q) slice).

The sweep's device channel uses a ``torch.Generator``; this module reproduces
the reference's exact sequence on the host for the 'reference' channel mode,
so both packages decode the same noise:

* ``ReferenceLCG``: seeds x{249,251,252} mod {61967,63443,63599}, sum of
  fractional parts (bldpc_实习/LDPC_Encoder.cu:46-56).
* binary AWGN: sin-variant Box-Muller, y = sigma*sin(2*pi*u2)*sqrt(-2*ln(1-u1)) + (1-2c)
  (bldpc_实习/LDPC_Encoder.cu:25-41), frame-interleaved [bit][frame] layout.
"""

from __future__ import annotations

import numpy as np

PI = 3.1415926  # the reference's PI macro (define.cuh:58), NOT np.pi
DEFAULT_SEEDS = (173, 173, 173)


class ReferenceLCG:
    def __init__(self, seeds=DEFAULT_SEEDS):
        self.seed = list(seeds)

    def next(self) -> float:
        s = self.seed
        s[0] = (s[0] * 249) % 61967
        s[1] = (s[1] * 251) % 63443
        s[2] = (s[2] * 252) % 63599
        t = (np.float32(s[0]) / np.float32(61967) + np.float32(s[1]) / np.float32(63443)
             + np.float32(s[2]) / np.float32(63599))
        return float(t - int(t))

    def uniforms(self, n: int) -> np.ndarray:
        return np.array([self.next() for _ in range(n)], dtype=np.float64)


def awgn_binary(lcg: ReferenceLCG, codeword: np.ndarray, sigma: float,
                n_frames: int) -> np.ndarray:
    """Channel output [CW_Len, n_frames] (frame-interleaved like the reference)."""
    cw_len = codeword.shape[0]
    out = np.zeros((cw_len, n_frames), dtype=np.float64)
    for f in range(n_frames):
        for b in range(cw_len):
            u1 = lcg.next()
            u2 = lcg.next()
            temp = np.sqrt(-2.0 * np.log(1.0 - u1))
            out[b, f] = sigma * np.sin(2 * PI * u2) * temp + 1.0 - 2.0 * codeword[b, f] \
                if codeword.ndim == 2 else \
                sigma * np.sin(2 * PI * u2) * temp + 1.0 - 2.0 * codeword[b]
    return out
