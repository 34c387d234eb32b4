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
    """``None`` -> the current card, with its index (raises
    ``RuntimeError`` without a card); anything else is taken as the
    caller's explicit choice, and a card named without an index
    (``"cuda"``) gets the current one's.  So every device this returns
    names one card, and a cache keyed by it holds that card's tensors
    whatever card is current later."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; the codec runs on the GPU "
                "unless device='cpu' is requested explicitly"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device.type!r}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def card_lines() -> list[str]:
    """Every card's name and power limit, one line a card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return [ln.strip() for ln in out.splitlines()]


def card_info() -> str:
    """The first card's line of :func:`card_lines`.  Every recorded timing
    carries this line."""
    lines = card_lines()
    return lines[0] if lines else ""
