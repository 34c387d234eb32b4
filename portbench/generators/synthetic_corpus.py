"""The corpus stand-in: a frozen copy of ``synthetic_corpus`` from
``tinyimgcodec_tpu_torch/corpus.py:26-60`` at commit ``2360460``, with the
run's seed in place of its fixed one, so that a later change to the
program's corpus cannot move the yardstick.

Waves of 1.5-6 periods across the image, a checker of 20-60 pixel cells,
Gaussian noise of 5 levels; float64 arithmetic, ``RandomState``.  Square
images only.
"""

import numpy as np


def image(h: int, w: int, seq: np.random.SeedSequence) -> np.ndarray:
    """One (h, w) uint8 image.  The draws and the arithmetic are the copied
    function's; each term that varies along one axis only is computed once
    and broadcast, which gives the same values."""
    if h != w:
        raise ValueError("synthetic_corpus makes square images")
    size = h
    rng = np.random.RandomState(seq.generate_state(1)[0])
    x = np.arange(size)[None, :]
    y = np.arange(size)[:, None]
    fx, fy = rng.uniform(1.5, 6, 2)
    wave_x = np.sin(2 * np.pi * (fx * x / size + rng.rand()))
    wave_y = np.cos(2 * np.pi * (fy * y / size + rng.rand()))
    cell_x, cell_y = rng.randint(20, 60), rng.randint(20, 60)
    img = (
        110.0
        + 70.0 * wave_x * wave_y
        + 30.0 * ((x // cell_x + y // cell_y) % 2)
        + rng.randn(size, size) * 5.0
    )
    return np.clip(img, 0, 255).astype(np.uint8)
