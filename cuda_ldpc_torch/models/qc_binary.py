"""Binary QC-LDPC code structure (counterpart of
cuda_ldpc_tpu/models/qc_binary.py, copied so that the port needs nothing of
that package).

The reference flattens the circulant structure into a per-variable-node address
table (bldpc_实习/Simulation.cu:356-387) so one CUDA thread can gather its edges.
Here the J x L base matrix of shifts stays first-class and every message tensor
is ``[batch, edge, Z]``: the circulant permutation "VN z of column l connects to
CN row (z - shift) mod Z of block row j" (Simulation.cu:380) is a ``torch.roll``
along Z in the plain version and the index ``(r + shift) % Z`` in the kernels.

Derived dimensions use the consistent invariant the kernels rely on —
``n = L*Z``, ``m = J*Z``, ``k = (L-J)*Z`` — rather than the reference's
independently (and, as committed, inconsistently) hardcoded macros
(define.cuh:23-25; see SURVEY.md section 2.1).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from cuda_ldpc_torch.utils import registry


@dataclasses.dataclass(frozen=True)
class QCBinaryCode:
    """A binary QC-LDPC code defined by a base matrix of circulant shifts."""

    name: str
    base: np.ndarray        # [J, L] int, -1 = zero block, else right-shift in [0, Z)
    Z: int

    def __post_init__(self):
        base = np.asarray(self.base, dtype=np.int64)
        object.__setattr__(self, "base", base)
        if base.ndim != 2:
            raise ValueError("base matrix must be 2-D")
        if np.any((base < -1) | (base >= self.Z)):
            raise ValueError(f"shifts must lie in [-1, {self.Z})")

    # --- dimensions -------------------------------------------------------
    @property
    def J(self) -> int:
        return self.base.shape[0]

    @property
    def L(self) -> int:
        return self.base.shape[1]

    @property
    def n(self) -> int:          # codeword length (CW_Len = L*Z)
        return self.L * self.Z

    @property
    def m(self) -> int:          # parity length (parLen = J*Z)
        return self.J * self.Z

    @property
    def k(self) -> int:          # message length (msgLen = (L-J)*Z)
        return self.n - self.m

    @property
    def rate(self) -> float:
        return self.k / self.n

    # --- structure --------------------------------------------------------
    @functools.cached_property
    def edges(self) -> np.ndarray:
        """[E, 3] array of (j, l, shift) for every non-null block, row-major —
        the same edge enumeration order the reference's address compiler uses
        (Simulation.cu:363-385)."""
        js, ls = np.nonzero(self.base != -1)
        return np.stack([js, ls, self.base[js, ls]], axis=1)

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    @functools.cached_property
    def row_edges(self) -> list[np.ndarray]:
        """Per block-row j: indices into ``edges`` (ascending l)."""
        return [np.nonzero(self.edges[:, 0] == j)[0] for j in range(self.J)]

    @functools.cached_property
    def col_edges(self) -> list[np.ndarray]:
        """Per block-column l: indices into ``edges`` (ascending j)."""
        return [np.nonzero(self.edges[:, 1] == l)[0] for l in range(self.L)]

    @functools.cached_property
    def row_weights(self) -> np.ndarray:
        return (self.base != -1).sum(axis=1)

    @functools.cached_property
    def col_weights(self) -> np.ndarray:
        return (self.base != -1).sum(axis=0)

    @functools.cached_property
    def dense_H(self) -> np.ndarray:
        """Fully lifted [m, n] parity-check matrix (uint8) for oracles/tests."""
        H = np.zeros((self.m, self.n), dtype=np.uint8)
        Z = self.Z
        for j, l, s in self.edges:
            rows = np.arange(Z)
            cols = (rows + s) % Z        # CN r connects VN z = (r + s) % Z
            H[j * Z + rows, l * Z + cols] = 1
        return H

    # --- constructors -----------------------------------------------------
    @classmethod
    def from_registry(cls, name: str) -> "QCBinaryCode":
        base, Z = registry.load_binary_base(name)
        return cls(name=name, base=base, Z=Z)

    def __repr__(self) -> str:
        return (f"QCBinaryCode({self.name}: J={self.J}, L={self.L}, Z={self.Z}, "
                f"n={self.n}, k={self.k}, E={self.num_edges})")
