"""The port's measuring tools, each run as ``python -m
cuda_ldpc_torch.tools.<name>``: the phase split of the binary decode
(``profile_phases``) and the three probes that were TPU kernels in the JAX
package's ``tools/`` (``probe_bitops``, ``probe_mosaic``, ``probe_oprate``),
each with its hand-written CUDA kernel in ``csrc/`` and its plain PyTorch
version.  Importing this package imports nothing."""
