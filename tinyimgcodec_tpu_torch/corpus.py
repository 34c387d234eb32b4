"""Test-corpus loading (the reference's data/ images, with fallback).

The reference ships 49 numbered 512x512 grayscale GIFs plus lenna.gif in
its ``data/`` directory.  The port looks for that directory at
``REFERENCE_DATA``, ``data/`` at the root of the checkout (it reads
nothing outside its checkout).  When it is there the loaders read it
(with Pillow, imported only then: a corpus that cannot be read raises,
it is never replaced by the synthetic images); otherwise a deterministic
synthetic corpus of similar statistics, generated from fixed seeds, stands
in, as in the JAX package.  Also: encoded blocks of any bit lengths for
the stream assembly.
"""

from __future__ import annotations

import os

import numpy as np

REFERENCE_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

# name -> corpus file, as the reference's figure script names them:
# Lenna = lenna.gif, Babara = 1.gif, Baboon = 47.gif
NAMED_IMAGES = {"Lenna": "lenna.gif", "Babara": "1.gif", "Baboon": "47.gif"}


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


def seeded_image(h: int, w: int, seed: int) -> np.ndarray:
    """An (h, w) uint8 image made from a seed as the corpus images are:
    waves, a checker of random cells and noise (float32 throughout)."""
    rng = np.random.default_rng(seed)
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


def corpus_available() -> bool:
    return os.path.isdir(REFERENCE_DATA)


def load_corpus(limit: int | None = None) -> np.ndarray:
    """(N, 512, 512) uint8: the 49 numbered corpus images (or synthetic)."""
    if not corpus_available():
        return synthetic_corpus(limit or 49)
    from PIL import Image

    n = 49 if limit is None else min(limit, 49)
    out = []
    for i in range(1, n + 1):
        path = os.path.join(REFERENCE_DATA, f"{i}.gif")
        out.append(np.asarray(Image.open(path).convert("L")))
    return np.stack(out)


def load_named(name: str) -> np.ndarray:
    """One named image of ``NAMED_IMAGES`` (or ``synthetic_corpus(1)[0]``)."""
    if not corpus_available():
        return synthetic_corpus(1)[0]
    from PIL import Image

    path = os.path.join(REFERENCE_DATA, NAMED_IMAGES[name])
    return np.asarray(Image.open(path).convert("L"))


def blocks_of_random_bits(image_bits, seed: int = 0, from_bit0: bool = False):
    """Encoded blocks of the given bit lengths, filled with random bits.

    ``image_bits``: one list of block lengths (at most 1664 bits each) an
    image, all equally long.  Returns ``(packed, meta, nb, stream_bits)``
    in the layout of the fused encode kernel's outputs: ``packed`` (N, 56)
    uint32 rows shifted to their block's bit phase and zero outside its
    bits, ``meta`` (2, N) int32 global bit offsets (every image's start
    rounded up to a byte) and bit counts, and the whole stream as one
    array of bits, built independently of the rows.  ``from_bit0``: the
    v1 encode kernel's layout instead, (N, 52) rows packed from bit 0 (the
    same bits for the same seed)."""
    rng = np.random.RandomState(seed)
    nb = len(image_bits[0])
    offs, lens, pos = [], [], 0
    for lengths in image_bits:
        if len(lengths) != nb:
            raise ValueError("every image needs the same number of blocks")
        pos = (pos + 7) & ~7
        for ln in lengths:
            offs.append(pos)
            lens.append(ln)
            pos += ln
    stream_bits = np.zeros(pos, np.uint8)
    rows = np.zeros((len(offs), (52 if from_bit0 else 56) * 32), np.uint8)
    for b, (o, ln) in enumerate(zip(offs, lens)):
        chunk = rng.randint(0, 2, ln).astype(np.uint8)
        stream_bits[o:o + ln] = chunk
        phase = 0 if from_bit0 else o & 31
        rows[b, phase:phase + ln] = chunk
    packed = np.packbits(rows, axis=1).view(">u4").astype(np.uint32)
    return packed, np.array([offs, lens], np.int32), nb, stream_bits
