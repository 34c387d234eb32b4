"""Device selection for the port's entry points.

One rule, applied everywhere: ``device=None`` means the CUDA card.  If no
card is there the entry point raises -- it never carries on on the CPU on
its own.  The CPU is used only when the caller asks for it by name
(``device="cpu"``), which is what the tests do; CPU tensors take each
kernel's plain PyTorch version, CUDA tensors take the hand-written kernel.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` without a card);
    anything else is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; the codec runs on the GPU "
                "unless device='cpu' is requested explicitly"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device.type!r}")
    return device


def card_info() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (first card).  Every recorded timing carries this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0].strip() if out else ""
