"""Device resolution for the port's entry points."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU. Raises when CUDA is asked for (the default) and is missing;
    nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` prints them:
    the line that stands beside every number measured on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
