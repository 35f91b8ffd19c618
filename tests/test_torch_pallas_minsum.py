"""The JAX package's binary min-sum TPU kernels (cuda_ldpc_tpu.ops
.pallas_minsum: K1 flooding, K2 layered), run in interpret mode as their
own tests run them on the CPU, against the port's plain decoders on the
same numpy LLRs.  Tolerance: none (hard, ok and iters exactly equal).  Each
call costs about 20 s of interpretation here, so these two cases have a
file of their own: the rest of each decoder's cases, held to the JAX
package's jnp decoders, are in tests/test_torch_minsum.py and
tests/test_torch_layered_bp.py."""

import jax.numpy as jnp
import torch

from cuda_ldpc_tpu.ops import pallas_minsum
from cuda_ldpc_torch.ops import minsum

import test_torch_layered_bp as layered_bp
from test_torch_minsum import _assert_same, _code, _llrs, _port


def test_decode_flooding_matches_pallas_interpret():
    """The TPU kernel, run as its own tests run it on the CPU.  Its early
    stop is per 8-frame tile; with B = 8 there is one tile, so it equals the
    batch-global stop."""
    code = _code("J4_L24_Z256")
    chan = _llrs(code, 0.45, 8, seed=5)
    a = pallas_minsum.decode_flooding(jnp.asarray(chan), code, 3,
                                      check="syndrome", early_stop=True,
                                      interpret=True)
    b = minsum.decode_flooding(torch.from_numpy(chan), _port(code), 3,
                               check="syndrome", early_stop=True)
    _assert_same(a, b)


def test_decode_layered_matches_pallas_interpret():
    """The TPU kernel, run as its own tests run it on the CPU.  Its early
    stop is per 8-frame tile; with B = 8 there is one tile, so it equals the
    batch-global stop.  (Its total update, (T + R_new) - R_old, rounds
    otherwise than T + (R_new - R_old); on this input both agree.)"""
    code, port = layered_bp._codes("J4_L24_Z256")
    chan = layered_bp._llrs(code, 0.5, 8, seed=6)
    a = pallas_minsum.decode_layered(jnp.asarray(chan), code, 3,
                                     check="syndrome", early_stop=True,
                                     interpret=True)
    b = minsum.decode_layered(torch.from_numpy(chan), port, 3,
                              check="syndrome", early_stop=True)
    layered_bp._assert_same(a, b)
