"""cuda_ldpc_torch — the LDPC link simulator in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``cuda_ldpc_tpu`` (JAX/Pallas on a TPU), which stays beside it as
the reference this package is tested against.  The code structures, the
registry, the config dataclasses and the reference LCG are that package's
jax-free host layer, imported rather than copied; everything that touches
tensors is PyTorch here, with an explicit ``device`` and explicit
``torch.Generator``s.

Layout:
    ops/       channel, minsum (plain PyTorch), cuda_minsum (kernel wrapper),
               _build (nvcc + ctypes loader)
    csrc/      CUDA C++ kernel sources, built at first use
    utils/     device resolution, binomial confidence intervals
    sim.py     Monte-Carlo SNR sweeps (binary batch engine)
    cli.py     python -m cuda_ldpc_torch
"""

from cuda_ldpc_tpu.models.nb_code import NBCode
from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode
from cuda_ldpc_tpu.utils import registry

__version__ = "0.1.0"

__all__ = ["QCBinaryCode", "NBCode", "registry", "__version__"]
