"""Quality/rate metrics for benchmark parity with the reference.

The reference's PSNR helper (tests/psnr.py:5-9) computes the MSE on raw
uint8 arrays, so differences wrap mod 256 (verified SURVEY quirk 2.5-5);
its published figures use that formula.  Both the wrapped formula (for
parity) and the correct float PSNR are provided.
"""

from __future__ import annotations

import numpy as np


def psnr_reference(a: np.ndarray, b: np.ndarray) -> float:
    """Reference-parity PSNR: uint8 subtraction wraps mod 256."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    mse = np.mean(((a - b) ** 2).astype(np.float64))
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(255.0 / np.sqrt(mse)))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """Correct float64 PSNR."""
    diff = np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)
    mse = np.mean(diff * diff)
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(255.0 / np.sqrt(mse)))


def compression_ratio(image: np.ndarray, data: bytes) -> float:
    return float(np.asarray(image).size) / float(len(data))


MEGAPIXEL = 1e6


def megapixels(image_shape) -> float:
    h, w = image_shape[-2:]
    return h * w / MEGAPIXEL
