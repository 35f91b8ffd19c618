"""cuda_ldpc_torch — the LDPC link simulator in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``cuda_ldpc_tpu`` (JAX/Pallas on a TPU), which stays beside it as
the reference this package is tested against.  The port imports nothing of
that package: its host layer (code structures, registry, config dataclasses,
reference LCG) is its own copy, under the same module names, so a reader
finds each counterpart.  Everything that touches tensors is PyTorch, with an
explicit ``device`` and explicit ``torch.Generator``s.

Layout:
    models/    qc_binary (QC-LDPC code structure), nb_code (GF(q) code
               structure)
    ops/       channel, demod (GF(q) symbol LLRs), minsum (plain PyTorch:
               flooding and layered, min-sum and sum-product), nb_decode
               (plain PyTorch: GF(q) FFT-QSPA, EMS and TMM, flooding,
               layered and grouped layered), the stream steps, cuda_minsum,
               cuda_qspa, cuda_qspa_qc, cuda_nbms and the stream kernels'
               wrappers, _build (nvcc + ctypes loader)
    csrc/      CUDA C++ kernel sources, built at first use
    utils/     registry + io (code assets), gf (GF(2^m) tables),
               constellations, lcg + native (the reference's channel),
               device resolution, binomial confidence intervals
    config.py  sweep and decoder configuration
    sim.py     Monte-Carlo SNR sweeps (binary and GF(q); batch, packed and
               stream engines)
    cli.py     python -m cuda_ldpc_torch
"""

from cuda_ldpc_torch.models.nb_code import NBCode
from cuda_ldpc_torch.models.qc_binary import QCBinaryCode
from cuda_ldpc_torch.utils import registry

__version__ = "0.1.0"

__all__ = ["NBCode", "QCBinaryCode", "registry", "__version__"]
