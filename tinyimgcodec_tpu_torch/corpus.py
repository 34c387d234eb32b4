"""Deterministic synthetic test corpus.

Stands in for the reference's 49 numbered 512x512 grayscale images with
images of similar statistics, generated from fixed seeds.
"""

from __future__ import annotations

import numpy as np


def synthetic_corpus(n: int = 49, size: int = 512) -> np.ndarray:
    """Deterministic natural-ish grayscale images, (n, size, size) uint8."""
    out = np.empty((n, size, size), np.uint8)
    y, x = np.mgrid[0:size, 0:size]
    for i in range(n):
        rng = np.random.RandomState(1000 + i)
        fx, fy = rng.uniform(1.5, 6, 2)
        img = (
            110.0
            + 70.0 * np.sin(2 * np.pi * (fx * x / size + rng.rand()))
            * np.cos(2 * np.pi * (fy * y / size + rng.rand()))
            + 30.0 * ((x // rng.randint(20, 60) + y // rng.randint(20, 60)) % 2)
            + rng.randn(size, size) * 5.0
        )
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out
