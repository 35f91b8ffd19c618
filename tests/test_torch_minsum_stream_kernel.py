"""The binary stream step's plain PyTorch version
(cuda_ldpc_torch.ops.minsum_stream, K4's reference) against the JAX
package's TPU kernel cuda_ldpc_tpu/ops/pallas_minsum_stream.stream_step in
interpret mode, on the same numpy LLRs.  Tolerance: none on R, hard, t,
done and okf; the layered totals within 1e-5, since the kernel rounds its
update as (T + R_new) - R_old where the port adds T + (R_new - R_old).
About 20 s a call here, so one case, in a file of its own; the others are
held to the JAX package's jnp core in tests/test_torch_minsum_stream.py, as
the JAX tests hold the kernel."""

import jax.numpy as jnp
import numpy as np
import pytest

from cuda_ldpc_tpu.ops import pallas_minsum_stream
from cuda_ldpc_tpu.ops.pallas_minsum import _lane_pad

from test_torch_minsum_stream import _chan, _port_step, _sigma, codes  # noqa: F401


def _jax_step(jc, chan, k, max_it, check, rule, layered):
    """The JAX kernel in interpret mode on fresh slots; outputs in the
    port's layout."""
    B = chan.shape[0]
    Zp = _lane_pad(jc.Z)
    cm = np.zeros((jc.L, B, Zp), np.float32)
    cm[:, :, :jc.Z] = chan.transpose(1, 0, 2)
    z = jnp.zeros((B, 128), jnp.int32)
    out = pallas_minsum_stream.stream_step(
        jnp.asarray(cm), jnp.zeros((jc.num_edges, B, Zp), jnp.float32), z, z,
        z, jc, k=k, max_iters=max_it, check=check, rule=rule,
        layered=layered, interpret=True)
    c2, R2, hard, t2, d2, o2 = (np.asarray(x) for x in out)
    lz = lambda x: x[:, :, :jc.Z].transpose(1, 0, 2)       # noqa: E731
    return lz(c2), lz(R2), lz(hard), t2[:, 0], d2[:, 0], o2[:, 0]


@pytest.mark.parametrize("schedule,check,rule",
                         [("layered", "syndrome", "minsum")])
def test_stream_step_matches_the_jax_kernel(codes, schedule, check, rule):
    """The JAX kernel itself, in interpret mode."""
    jc, pc = codes
    B, k, max_it = 8, 6, 12
    chan = _chan(jc, B, _sigma(rule), seed=3, rule=rule)
    want = _jax_step(jc, chan, k, max_it, check, rule, schedule == "layered")
    got = _port_step(pc, chan, k, max_it, check, rule, schedule == "layered")
    for a, b in zip(want[1:], got[1:]):                  # R, hard, t, done, okf
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(want[0], got[0], rtol=1e-5, atol=1e-5)
