"""Transform stage in plain PyTorch: blockify -> DCT -> quantize -> zig-zag,
and back: undo DPCM -> dequantize -> inverse DCT -> pixels.

These are ordinary tensor functions that run on whatever device their
input lies on.  The encode path on the card goes through the hand-written
kernels (``ops/exact_transform.py``, ``ops/encode2.py``); the encode
functions here are their yardsticks and the layout helpers around them.
The decode half (:func:`undo_dpcm`, :func:`decode_blocks`) is the port of
plain XLA programs of the JAX package -- one matrix product and a few
elementwise passes -- and is what the decode path runs on the card.

Two precisions, as in the JAX package:

- ``"fast"``: the fused float32 (64, 64) transform summed in the encode
  kernel's own order, one rounding a product and a sum, and ``torch.round``
  (round-half-to-even, like ``jnp.round``): ``encode2``'s
  ``fast_coefficients_plain``, the definition of fast mode's coefficients
  on every device.  The JAX package sums in XLA's order, so a value that
  sits on a rounding tie may come out one step away there.
- ``"exact"``: float64 arithmetic (the card has FP64 units, so the JAX
  package's double-float emulation is not needed) with a per-block flag
  for roundings within 1e-9 of a tie.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tables import CodecTables, DecodeTables
from .encode2 import fast_coefficients_plain

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
    it marks blocks with a rounding within 1e-9 of a tie (already settled
    in the float64 oracle's arithmetic); in fast mode it is all False.
    """
    if tables is None:
        tables = CodecTables.build(quality, blocks.device)
    lead = blocks.shape[:-2]
    if precision == FAST:
        zz = fast_coefficients_plain(
            blocks.reshape(-1, 64).to(torch.uint8), tables
        ).T.reshape(*lead, 64)
        flags = torch.zeros(lead, dtype=torch.bool, device=blocks.device)
    elif precision == EXACT:
        from .exact_transform import exact_transform_plain

        zz_cm, f, _ = exact_transform_plain(
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


def undo_dpcm(zz: torch.Tensor) -> torch.Tensor:
    """(..., nb, 64) int32 coefficients whose column 0 holds DC
    differences -> the same with the running DC (int32 wrap-around, as
    the oracle's int64 sum cast back to int32)."""
    dc = torch.cumsum(zz[..., 0].to(torch.int64), dim=-1).to(torch.int32)
    return torch.cat([dc[..., None], zz[..., 1:]], dim=-1)


# a decoded value this close to an integer may floor differently in the
# oracle's float64 arithmetic (scipy's inverse DCT sums in another order)
FLOOR_TIE_EPS = 1e-9


def decode_blocks(
    zz: torch.Tensor,
    quality: int,
    precision: str = EXACT,
    scaled_dct: bool = False,
    with_flags: bool = False,
    tables: DecodeTables | None = None,
):
    """(..., nb, 64) int32 zig-zag coefficients (DC already un-DPCM'd) ->
    (..., nb, 8, 8) uint8 pixel blocks.

    Fast: one float32 (64, 64) matrix product, ``floor(clip(x + 128))``.
    Exact: the same product in float64, ``floor`` then clip.  With
    ``with_flags=True`` also a per-block bool: in exact mode it marks
    blocks holding a value within 1e-9 of an integer inside (0.5, 255.5),
    where the float64 host oracle might floor the other way (such blocks
    are recomputed by it); in fast mode it is all False.
    """
    if tables is None:
        tables = DecodeTables.build(quality, scaled_dct, zz.device)
    lead = zz.shape[:-1]
    if precision == FAST:
        x = zz.to(torch.float32) @ tables.fast_matrix
        pix = torch.floor(torch.clamp(x + 128.0, 0.0, 255.0))
        flags = torch.zeros(lead, dtype=torch.bool, device=zz.device)
    elif precision == EXACT:
        x = zz.to(torch.float64) @ tables.exact_matrix + 128.0
        near = (x - torch.round(x)).abs() < FLOOR_TIE_EPS
        flags = (near & (x > 0.5) & (x < 255.5)).any(dim=-1)
        pix = torch.clamp(torch.floor(x), 0.0, 255.0)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    out = pix.to(torch.uint8).reshape(*lead, 8, 8)
    if with_flags:
        return out, flags
    return out
