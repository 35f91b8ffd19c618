"""Statistical acceptance bounds for Monte-Carlo FER/BER estimates
(counterpart of cuda_ldpc_tpu/utils/stats.py, which inverts the incomplete
beta function through jax; here scipy's exact beta quantiles do it).

``clopper_pearson`` gives the exact binomial confidence interval for an
observed error count, so "FER parity" between two runs or decoders is the
well-defined question "do the intervals overlap".
"""

from __future__ import annotations

from scipy.stats import beta as _beta


def clopper_pearson(errors: int, frames: int,
                    confidence: float = 0.95) -> tuple[float, float]:
    """Exact (Clopper-Pearson) two-sided confidence interval for a binomial
    rate given ``errors`` observed in ``frames`` trials.

    Returns (lo, hi) with lo = 0 when errors == 0 and hi = 1 when
    errors == frames (the standard one-sided degenerate cases).
    """
    if not 0 <= errors <= frames or frames <= 0:
        raise ValueError(f"need 0 <= errors <= frames, got {errors}/{frames}")
    alpha = 1.0 - confidence
    lo = (0.0 if errors == 0
          else float(_beta.ppf(alpha / 2, errors, frames - errors + 1)))
    hi = (1.0 if errors == frames
          else float(_beta.ppf(1 - alpha / 2, errors + 1, frames - errors)))
    return lo, hi


def rates_compatible(errors_a: int, frames_a: int, errors_b: int,
                     frames_b: int, confidence: float = 0.999) -> bool:
    """True when two observed error rates are statistically compatible:
    their exact confidence intervals overlap."""
    lo_a, hi_a = clopper_pearson(errors_a, frames_a, confidence)
    lo_b, hi_b = clopper_pearson(errors_b, frames_b, confidence)
    return lo_a <= hi_b and lo_b <= hi_a
