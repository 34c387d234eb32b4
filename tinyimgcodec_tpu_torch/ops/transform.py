"""Transform stage in plain PyTorch: blockify -> DCT -> quantize -> zig-zag.

These are ordinary tensor functions that run on whatever device their
input lies on.  The encode path on the card goes through the hand-written
kernels (``ops/exact_transform.py``, ``ops/encode2.py``); the functions
here are their yardsticks and the layout helpers around them.

Two precisions, as in the JAX package:

- ``"fast"``: one float32 (64, 64) matrix product and ``torch.round``
  (round-half-to-even, like ``jnp.round``).  Order-dependent: a value that
  sits on a rounding tie may come out one step away on another backend.
- ``"exact"``: float64 arithmetic (the card has FP64 units, so the JAX
  package's double-float emulation is not needed) with a per-block flag
  for roundings within 1e-9 of a tie.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tables import CodecTables

FAST = "fast"
EXACT = "exact"


def pad_to_blocks(image: np.ndarray) -> np.ndarray:
    """Host-side reflect pad of (..., H, W) to multiples of 8."""
    h, w = image.shape[-2:]
    ph = -h % 8
    pw = -w % 8
    if ph or pw:
        pad = [(0, 0)] * (image.ndim - 2) + [(0, ph), (0, pw)]
        image = np.pad(image, pad, mode="reflect")
    return image


def blockify(image: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H/8 * W/8, 8, 8) in raster block order."""
    *lead, h, w = image.shape
    x = image.reshape(*lead, h // 8, 8, w // 8, 8)
    x = x.transpose(-3, -2)
    return x.reshape(*lead, (h // 8) * (w // 8), 8, 8)


def unblockify(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    *lead, _, _, _ = blocks.shape
    x = blocks.reshape(*lead, h // 8, w // 8, 8, 8)
    x = x.transpose(-3, -2)
    return x.reshape(*lead, h, w)


def encode_blocks(
    blocks: torch.Tensor,
    quality: int,
    precision: str = EXACT,
    with_flags: bool = False,
    tables: CodecTables | None = None,
):
    """(..., nb, 8, 8) uint8/int pixels -> (..., nb, 64) int32 zig-zag
    quantized coefficients (DC at index 0, not yet DPCM'd).

    with_flags=True additionally returns a per-block bool: in exact mode
    it marks blocks with a rounding within 1e-9 of a tie (to be
    recomputed by the float64 host oracle); in fast mode it is all False.
    """
    if tables is None:
        tables = CodecTables.build(quality, blocks.device)
    lead = blocks.shape[:-2]
    if precision == FAST:
        x = blocks.reshape(*lead, 64).to(torch.float32)
        y = x @ tables.encode_matrix
        y[..., 0] = y[..., 0] - tables.dc_offset
        zz = torch.round(y).to(torch.int32)
        flags = torch.zeros(lead, dtype=torch.bool, device=blocks.device)
    elif precision == EXACT:
        from .exact_transform import exact_transform_plain

        zz_cm, f = exact_transform_plain(
            blocks.reshape(-1, 64).to(torch.uint8), tables
        )
        zz = zz_cm.T.reshape(*lead, 64)
        flags = f.to(torch.bool).reshape(lead)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    if with_flags:
        return zz, flags
    return zz


def dc_dpcm(zz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split (..., nb, 64) into DPCM'd DC (..., nb) and AC (..., nb, 63).

    Raster-order DPCM over the block axis; the first block keeps its raw
    DC."""
    dc = zz[..., 0]
    prev = torch.cat([torch.zeros_like(dc[..., :1]), dc[..., :-1]], dim=-1)
    return dc - prev, zz[..., 1:]
