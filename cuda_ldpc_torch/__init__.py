"""cuda_ldpc_torch — the LDPC link simulator in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``cuda_ldpc_tpu`` (JAX/Pallas on a TPU), which stays beside it as
the reference this package is tested against.  The port imports nothing of
that package: its host layer (code structures, registry, config dataclasses,
reference LCG) is its own copy, under the same module names, so a reader
finds each counterpart.  Everything that touches tensors is PyTorch, with an
explicit ``device`` and explicit ``torch.Generator``s.

Layout:
    models/    qc_binary (QC-LDPC code structure)
    ops/       channel, minsum (plain PyTorch: flooding and layered, min-sum
               and sum-product), cuda_minsum (kernel wrappers), _build (nvcc
               + ctypes loader)
    csrc/      CUDA C++ kernel sources, built at first use
    utils/     registry + io (code assets), lcg + native (the reference's
               channel), device resolution, binomial confidence intervals
    config.py  sweep and decoder configuration
    sim.py     Monte-Carlo SNR sweeps (binary batch engine)
    cli.py     python -m cuda_ldpc_torch
"""

from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
from cuda_ldpc_torch.utils import registry

__version__ = "0.1.0"

__all__ = ["QCBinaryCode", "registry", "__version__"]
