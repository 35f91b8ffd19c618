"""Asset registry: resolves named codes to loadable files (counterpart of
cuda_ldpc_tpu/utils/registry.py:1-129).

Search order for code definition files, the JAX package's first two places,
so that both find the same files:
1. ``$CUDA_LDPC_TPU_ASSETS`` (colon-separated directories)
2. ``<repo>/assets/`` (npz imports created by ``tools/import_assets.py``)
(The JAX package also looks in a read-only checkout of the CUDA reference;
the port takes such files through ``$CUDA_LDPC_TPU_ASSETS``.)

The 12 shipped binary BlockH matrices + PON_LDPC and the non-binary codes are
all addressable by their reference filenames (minus extension).
"""

from __future__ import annotations

import os
import pathlib
import re

import numpy as np

from cuda_ldpc_torch.utils import io as ldpc_io

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
ASSETS_DIR = _REPO_ROOT / "assets"

# Binary codes with dims not inferable from the filename.
_EXPLICIT_BINARY_DIMS = {"PON_LDPC": (12, 69, 256)}

BINARY_CODES = [
    "J4_L24_Z96", "J4_L24_Z256", "J4_L24_Z512", "J6_L24_Z96", "J8_L24_Z96",
    "J10_L60_Z160", "J12_L24_Z96", "J12_L60_Z160", "J15_L30_Z1280",
    "J15_L60_Z160", "J20_L60_Z160", "J24_L60_Z160", "J30_L60_Z160",
    "J32_L64_Z64", "J36_L60_Z160", "J40_L60_Z160", "J48_L60_Z160", "PON_LDPC",
]

NB_CODES = [
    "BDS.576.288.GF.64",
    "LDPC_N576_K288_GF64_d1_exp",
    "LDPC_N96_K48_GF256_d1_exp",
    "LDPC_N576_K480_GF256_exp",
    "Tanner_74_9_Z128_GF16",
]


def _search_dirs() -> list[pathlib.Path]:
    dirs: list[pathlib.Path] = []
    env = os.environ.get("CUDA_LDPC_TPU_ASSETS")
    if env:
        dirs += [pathlib.Path(p) for p in env.split(":") if p]
    dirs.append(ASSETS_DIR)
    return [d for d in dirs if d.is_dir()]


def _find(name: str, exts: tuple[str, ...]) -> pathlib.Path | None:
    for d in _search_dirs():
        for ext in exts:
            p = d / f"{name}{ext}"
            if p.is_file():
                return p
    return None


def load_binary_base(name: str) -> tuple[np.ndarray, int]:
    """Resolve a binary code name -> (base matrix [J, L], Z)."""
    p = _find(name, (".npz",))
    if p is not None:
        with np.load(p) as data:
            return data["base"].astype(np.int64), int(data["Z"])
    suffix = "" if name == "PON_LDPC" else "_BlockH"
    p = _find(f"{name}{suffix}", (".txt",))
    if p is None:
        raise FileNotFoundError(f"binary code {name!r} not found in {_search_dirs()}")
    dims = _EXPLICIT_BINARY_DIMS.get(name)
    if dims:
        return ldpc_io.parse_blockh(str(p), *dims)
    return ldpc_io.parse_blockh(str(p))


def load_nb_code_file(name: str) -> ldpc_io.NBCodeFile:
    p = _find(name, (".npz",))
    if p is not None:
        with np.load(p) as d:
            return ldpc_io.NBCodeFile(
                int(d["n_sym"]), int(d["m_sym"]), int(d["q"]),
                int(d["max_dv"]), int(d["max_dc"]),
                d["vn_weight"], d["cn_weight"], d["vn_links"], d["vn_gf"],
                d["cn_links"], d["cn_gf"])
    p = _find(name, (".txt",))
    if p is None:
        raise FileNotFoundError(f"NB code {name!r} not found in {_search_dirs()}")
    return ldpc_io.parse_nb_code(str(p))


def load_test_codeword(n_sym: int) -> np.ndarray:
    """The fixture codeword of the reference's codeword_test.h
    (myNBLDPC/include/codeword_test.h:1) — the transmitted codeword the NB
    simulator pins instead of encoding (it ships no encoder): from
    ``codeword_test_<n_sym>.npz``, or from the first non-commented array of
    a ``codeword_test.h`` in the search directories if its length matches
    ``n_sym``."""
    npz = _find(f"codeword_test_{n_sym}", (".npz",))
    if npz is not None:
        with np.load(npz) as d:
            return d["symbols"].astype(np.int64)
    p = _find("codeword_test", (".h",))
    if p is None:
        raise FileNotFoundError("codeword_test.h not found")
    text = "\n".join(ln for ln in p.read_text().splitlines()
                     if not ln.lstrip().startswith("//"))
    m = re.search(r"CodeWord_sym_test\s*\[(\d+)\]\s*=\s*\{([^}]*)\}", text,
                  re.S)
    if not m:
        raise ValueError(f"no active codeword array in {p}")
    vals = np.array([int(t) for t in m.group(2).replace(",", " ").split()],
                    dtype=np.int64)
    if vals.size != n_sym:
        raise ValueError(
            f"fixture codeword has {vals.size} symbols, code needs {n_sym}")
    return vals
