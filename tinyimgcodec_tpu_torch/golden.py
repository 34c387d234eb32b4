"""Trusted host (numpy/scipy float64) implementation of the codec math.

This module is the *normative semantics oracle* for the device pipeline: every
device kernel is tested against it, and it is itself pinned to the reference
implementation's verified behavior (SURVEY.md 2.5) by golden-vector tests:

- DCT/IDCT: separable orthonormal float64 transforms
  (reference utils.py:32-45 uses scipy.fftpack with norm="ortho").
- Forward quantize: round-half-to-even on float64, cast int32
  (reference utils.py:48-53).
- Decode output: ``clip(x+128, 0, 255)`` then truncation toward zero via
  ``astype(uint8)`` -- NOT rounding (reference codec.py:68-70).
- Padding: reflect-mode to the next multiple of 8 (reference utils.py:56-61).
- DC DPCM in raster order over all blocks (reference codec.py:34-35).

Unlike the reference, the array-level API here is self-consistent:
``decode_arrays(encode_arrays(x))`` round-trips (the reference raises
KeyError, SURVEY quirk 2.5-4).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.fftpack import dct, idct

from .constants import (
    AAN_SCALES,
    INVERSE_ZIGZAG,
    ZIGZAG_ORDER,
    quant_divisors,
)


@dataclasses.dataclass
class CodecArrays:
    """Array-level encoded representation of one image."""

    height: int
    width: int
    quality: int
    dc: np.ndarray  # (nblocks,) int32, DPCM differences (dc[0] is raw)
    ac: np.ndarray  # (nblocks, 63) int32, zig-zag order
    scaled_dct: bool = False  # embedded fixed-point DCT stream (C encoder)

    @property
    def nblocks(self) -> int:
        return math.ceil(self.height / 8) * math.ceil(self.width / 8)


def bits_required(x: np.ndarray) -> np.ndarray:
    """JPEG category/size: ceil(log2(|x|+1)) (reference utils.py:9-10)."""
    return np.ceil(np.log2(np.abs(x).astype(np.float64) + 1)).astype(np.int32)


def pad_image(image: np.ndarray) -> np.ndarray:
    h, w = image.shape
    ph = math.ceil(h / 8) * 8 - h
    pw = math.ceil(w / 8) * 8 - w
    if ph or pw:
        image = np.pad(image, ((0, ph), (0, pw)), mode="reflect")
    return image


def block_slice(image: np.ndarray) -> np.ndarray:
    """(H, W) -> (H/8, W/8, 8, 8)."""
    h, w = image.shape
    return image.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2)


def block_combine(blocks: np.ndarray) -> np.ndarray:
    bh, bw, th, tw = blocks.shape
    return blocks.swapaxes(1, 2).reshape(bh * th, bw * tw)


def block_dct(blocks: np.ndarray) -> np.ndarray:
    return dct(dct(blocks, norm="ortho", axis=-2), norm="ortho", axis=-1)


def block_idct(blocks: np.ndarray) -> np.ndarray:
    return idct(idct(blocks, norm="ortho", axis=-2), norm="ortho", axis=-1)


def quantize(coeffs: np.ndarray, quality: int) -> np.ndarray:
    return np.round(coeffs / quant_divisors(quality)).astype(np.int32)


def dequantize(coeffs: np.ndarray, quality: int) -> np.ndarray:
    return coeffs * quant_divisors(quality)


def encode_arrays(image: np.ndarray, quality: int = 50) -> CodecArrays:
    """image (H, W) uint8-ish -> zig-zag quantized coefficient arrays."""
    height, width = image.shape
    padded = pad_image(np.asarray(image))
    blocks = block_slice(padded.astype(np.int32) - 128)
    coeffs = quantize(block_dct(blocks), quality)
    zz = coeffs.reshape(-1, 64)[:, ZIGZAG_ORDER]
    dc = zz[:, 0].copy()
    dc[1:] = np.diff(dc)
    return CodecArrays(
        height=height, width=width, quality=quality, dc=dc, ac=zz[:, 1:]
    )


def decode_arrays(arrays: CodecArrays) -> np.ndarray:
    """Inverse of encode_arrays (incl. the scaled_dct embedded-stream path,
    reference codec.py:46-70)."""
    bh = math.ceil(arrays.height / 8)
    bw = math.ceil(arrays.width / 8)
    dc = np.cumsum(arrays.dc.astype(np.int64)).astype(np.int32)
    zz = np.empty((dc.shape[0], 64), dtype=np.int32)
    zz[:, 0] = dc
    zz[:, 1:] = arrays.ac
    coeffs = zz[:, INVERSE_ZIGZAG].astype(np.float64)
    quality = arrays.quality
    coeffs = coeffs.reshape(bh, bw, 8, 8)
    if arrays.scaled_dct:
        # Undo the embedded encoder's fixed-point AAN scaling: its qfactor
        # (0..3) selects divisor QUANT<<qfactor at quality-50 tables
        # (reference codec.py:59-62, c/img.c:164-180).
        coeffs = coeffs / AAN_SCALES * float(2 ** quality)
        quality = 50
    coeffs = dequantize(coeffs, quality)
    pixels = block_combine(block_idct(coeffs))
    pixels = np.clip(pixels + 128.0, 0.0, 255.0)
    return pixels[: arrays.height, : arrays.width].astype(np.uint8)


# ---------------------------------------------------------------------------
# Run-length encoding (host oracle for the device RLE kernel).
# ---------------------------------------------------------------------------

def run_length_encode(ac_row: np.ndarray) -> list[tuple[int, int]]:
    """63 zig-zag AC coefficients -> [(run, value), ...] + EOB.

    Semantics match reference huffman.py:12-33: zero runs >= 16 emit ZRL
    pairs; trailing zeros are dropped; EOB=(0,0) is ALWAYS appended (even
    when coefficient 63 is nonzero, unlike baseline JPEG).
    """
    out: list[tuple[int, int]] = []
    nz = np.nonzero(ac_row)[0]
    prev = -1
    for i in nz:
        i = int(i)
        run = i - prev - 1
        while run >= 16:
            out.append((15, 0))
            run -= 16
        out.append((run, int(ac_row[i])))
        prev = i
    out.append((0, 0))  # EOB
    return out


def run_length_decode(pairs: list[tuple[int, int]]) -> np.ndarray:
    """[(run, value), ...] incl. EOB -> dense AC row (<= 63 entries).

    Matches reference huffman.py:36-38: the trailing 0 created by EOB is
    dropped.
    """
    vals: list[int] = []
    for run, value in pairs:
        vals.extend([0] * run)
        vals.append(value)
    vals = vals[:-1]  # EOB's zero
    out = np.zeros(63, dtype=np.int32)
    out[: len(vals)] = vals
    return out
