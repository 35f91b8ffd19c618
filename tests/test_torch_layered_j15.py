"""Layered against flooding min-sum on J15_L30_Z1280 in the JAX package, with
the port's plain decode_layered held to the JAX one on the same frames.

On the card, layered min-sum with alpha 1 (the reference's rule) leaves more
J15_L30_Z1280 frames unconverged than flooding does near Es/N0 -1.5 dB.
These cases show that the JAX package's decode_layered does the same on the
same numpy LLRs, that the port's plain version equals it exactly (hard, ok,
iters) on this code, and that with alpha 0.8 both schedules converge every
frame, layered in about half flooding's iterations.  A batch of 8 at Es/N0
-1.6 dB, 50 iterations, zero check, batch-global early stop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_ldpc_tpu import QCBinaryCode
from cuda_ldpc_tpu.ops import minsum as jax_minsum
from cuda_ldpc_torch import QCBinaryCode as PortCode
from cuda_ldpc_torch.ops import channel, minsum


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, so the other test workers keep their cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("alpha", [1.0, 0.8])
def test_j15_layered_vs_flooding_in_jax(alpha):
    code = QCBinaryCode.from_registry("J15_L30_Z1280")
    port = PortCode(name=code.name, base=code.base, Z=code.Z)
    sigma = channel.sigma_from_snr(-1.6, code.rate, "esn0")
    rng = np.random.default_rng(0)
    y = (1.0 + sigma * rng.standard_normal((8, code.L, code.Z))
         ).astype(np.float32)
    kw = dict(alpha=alpha, check="zero", early_stop=True)
    flood = jax_minsum.decode_flooding(jnp.asarray(y), code, 50, **kw)
    lay = jax_minsum.decode_layered(jnp.asarray(y), code, 50, **kw)
    ours = minsum.decode_layered(torch.from_numpy(y), port, 50, **kw)

    np.testing.assert_array_equal(np.asarray(lay.hard), ours.hard.numpy())
    np.testing.assert_array_equal(np.asarray(lay.ok), ours.ok.numpy())
    assert int(lay.iters) == int(ours.iters)

    # unconverged frames of 8 and the batch's iterations, per schedule
    seen = {"flooding": (int((~np.asarray(flood.ok)).sum()), int(flood.iters)),
            "layered": (int((~np.asarray(lay.ok)).sum()), int(lay.iters))}
    expected = {1.0: {"flooding": (3, 50), "layered": (5, 50)},
                0.8: {"flooding": (0, 29), "layered": (0, 15)}}[alpha]
    assert seen == expected
