"""The large-frame stand-in: a frozen copy of ``seeded_image`` from
``tinyimgcodec_tpu_torch/corpus.py:26-60`` at commit ``2360460``, with the
run's seed in place of its fixed one.

Waves of 8-30 periods, a checker of 20-60 pixel cells, Gaussian noise of
5 levels; float32 arithmetic, ``default_rng``.
"""

import numpy as np


def image(h: int, w: int, seq: np.random.SeedSequence) -> np.ndarray:
    """One (h, w) uint8 frame."""
    rng = np.random.default_rng(seq)
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    fx, fy = rng.uniform(8, 30, 2)
    img = (110.0 + 70.0 * np.sin(2 * np.pi * (fx * x / w + rng.random()))
           * np.cos(2 * np.pi * (fy * y / h + rng.random()))
           ).astype(np.float32)
    img += 30.0 * ((x // rng.integers(20, 60) + y // rng.integers(20, 60))
                   % 2)
    img += rng.standard_normal((h, w), dtype=np.float32) * 5.0
    return np.clip(img, 0, 255).astype(np.uint8)
