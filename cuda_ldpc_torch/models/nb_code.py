"""Non-binary GF(q) LDPC code structure with padded static index maps
(counterpart of cuda_ldpc_tpu/models/nb_code.py:25-120, a numpy copy).

The reference stores the Tanner graph as per-node C++ objects with message
storage inside (myNBLDPC/include/struct.h:28-47) and rebuilds flat
cross-index link arrays for its GPU path (myNBLDPC/src/main.cu:133-188).
The same reverse-edge maps are derived here once, padded to (max_dv, max_dc)
with explicit masks, so message tensors are dense: c2v state is
[batch, M, max_dc, q] (CN-aligned), gathered to VN-aligned
[batch, N, max_dv, q] through ``vn_links * max_dc + vn_slot``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from cuda_ldpc_torch.utils import gf as gflib
from cuda_ldpc_torch.utils import registry
from cuda_ldpc_torch.utils.io import NBCodeFile


@dataclasses.dataclass(frozen=True)
class NBCode:
    name: str
    n_sym: int
    m_sym: int
    q: int
    max_dv: int
    max_dc: int
    vn_weight: np.ndarray    # [N]
    cn_weight: np.ndarray    # [M]
    vn_links: np.ndarray     # [N, max_dv] CN index, pad 0
    vn_gf: np.ndarray        # [N, max_dv] GF coefficient on that edge, pad 0
    cn_links: np.ndarray     # [M, max_dc] VN index, pad 0
    cn_gf: np.ndarray        # [M, max_dc]
    vn_mask: np.ndarray      # [N, max_dv] bool
    cn_mask: np.ndarray      # [M, max_dc] bool
    vn_slot: np.ndarray      # [N, max_dv]: slot of this VN in the CN's link list
    cn_slot: np.ndarray      # [M, max_dc]: slot of this CN in the VN's link list

    @property
    def q_bit(self) -> int:
        return int(self.q).bit_length() - 1

    @property
    def bit_length(self) -> int:
        return self.n_sym * self.q_bit

    @property
    def k_sym(self) -> int:
        return self.n_sym - self.m_sym

    @property
    def rate(self) -> float:
        # (N - M) / N, myNBLDPC/src/Simulation.cpp:372
        return self.k_sym / self.n_sym

    @functools.cached_property
    def mul_table(self) -> np.ndarray:
        return gflib.mul_table(self.q)

    @functools.cached_property
    def xor_table(self) -> np.ndarray:
        return gflib.xor_table(self.q)

    @functools.cached_property
    def inv_table(self) -> np.ndarray:
        return gflib.inv_table(self.q)

    @classmethod
    def from_file(cls, f: NBCodeFile, name: str = "") -> "NBCode":
        N, M = f.n_sym, f.m_sym
        vn_mask = np.arange(f.max_dv)[None, :] < f.vn_weight[:, None]
        cn_mask = np.arange(f.max_dc)[None, :] < f.cn_weight[:, None]
        vn_links = np.where(vn_mask, f.vn_links, 0)
        cn_links = np.where(cn_mask, f.cn_links, 0)
        # reverse-edge slots (the reference's index_in_VN / index_in_CN
        # linear searches, myNBLDPC/src/LDPC_Decoder.cpp:106-130, precomputed)
        vn_slot = np.zeros((N, f.max_dv), dtype=np.int64)
        cn_slot = np.zeros((M, f.max_dc), dtype=np.int64)
        for i in range(N):
            for d in range(f.vn_weight[i]):
                cn = f.vn_links[i, d]
                slots = np.nonzero(f.cn_links[cn] == i)[0]
                if len(slots) != 1:
                    raise ValueError(f"inconsistent adjacency at VN {i} edge {d}")
                vn_slot[i, d] = slots[0]
        for mrow in range(M):
            for d in range(f.cn_weight[mrow]):
                vn = f.cn_links[mrow, d]
                slots = np.nonzero(f.vn_links[vn] == mrow)[0]
                if len(slots) != 1:
                    raise ValueError(f"inconsistent adjacency at CN {mrow} edge {d}")
                cn_slot[mrow, d] = slots[0]
        return cls(name=name, n_sym=N, m_sym=M, q=f.q, max_dv=f.max_dv,
                   max_dc=f.max_dc, vn_weight=f.vn_weight,
                   cn_weight=f.cn_weight, vn_links=vn_links,
                   vn_gf=np.where(vn_mask, f.vn_gf, 0),
                   cn_links=cn_links, cn_gf=np.where(cn_mask, f.cn_gf, 0),
                   vn_mask=vn_mask, cn_mask=cn_mask, vn_slot=vn_slot,
                   cn_slot=cn_slot)

    @classmethod
    def from_registry(cls, name: str) -> "NBCode":
        return cls.from_file(registry.load_nb_code_file(name), name=name)

    def syndrome(self, symbols: np.ndarray) -> np.ndarray:
        """NumPy GF syndrome per check row for hard symbol decisions [N]."""
        mul = self.mul_table
        contrib = mul[self.cn_gf, symbols[self.cn_links]]
        contrib = np.where(self.cn_mask, contrib, 0)
        out = np.zeros(self.m_sym, dtype=np.int64)
        for d in range(self.max_dc):
            out ^= contrib[:, d]
        return out

    def __repr__(self) -> str:
        return (f"NBCode({self.name}: N={self.n_sym}, M={self.m_sym}, "
                f"GF({self.q}), dv<={self.max_dv}, dc<={self.max_dc})")
