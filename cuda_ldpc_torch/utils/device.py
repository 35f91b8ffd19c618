"""Explicit device resolution and the card's identity.

Every entry point of the port takes a ``device``; nothing picks one
silently.  Asking for ``cuda`` on a machine without a usable card raises
instead of falling back to the CPU, so a number measured on the CPU can
never be reported as a GPU number.
"""

from __future__ import annotations

import shutil
import subprocess

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``'cpu'``, ``'cuda'`` or ``'cuda:N'`` -> ``torch.device``; raises when
    a CUDA device is asked for and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} requested but only "
                               f"{torch.cuda.device_count()} CUDA devices exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} "
                         "(expected 'cpu' or 'cuda')")
    return dev


def card_info() -> str:
    """The first card's name and power limit, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (a card set below its maximum power runs slower under load, so
    every timing is reported beside this line)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found on PATH")
    out = subprocess.run([exe, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
