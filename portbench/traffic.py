"""The one generator of the benchmark's inputs, driven by a mix file.

A run's pool holds ``pool`` inputs of the configuration's shape and count,
each image made by the configuration's ``generator`` (``generators/<name>.py``,
frozen copies of the program's corpus generators) from its own seed
sequence, derived from the run's ``--seed``.  Every seed gives the same
shapes and counts; only the content moves with the seed.

A mix file (``mixes/<mix>.json``) names what a call sends
(``sends/<kind>.py``: the items made from the pool and the answers expected
of them) and how calls arrive (``loops/<kind>.py``), and gives their
parameters; see ``README.md``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

MIX_KEYS = {"sends", "loop", "pool", "check_every"}
GEN_THREADS = 8


def seed_sequence(seed: int, *path: int) -> np.random.SeedSequence:
    """A seed sequence for one image, from the run's seed (any integer)."""
    return np.random.SeedSequence([seed % (1 << 64), *path])


def pool_inputs(config: dict, seed: int, pool: int,
                image=None) -> list[np.ndarray]:
    """The pool of a run: ``pool`` inputs, input k ``images_per_call``
    images of the configuration's shape, (B, H, W) uint8.  ``image`` is the
    generator's function (the configuration's ``generators/<name>.py`` by
    default).  Made on a few threads; each image has its own generator, so
    the threads give the same images in any order."""
    if image is None:
        from .loader import Bench

        image = Bench().generator(config["generator"]).image
    n, h, w = config["images_per_call"], config["height"], config["width"]
    out = [np.empty((n, h, w), np.uint8) for _ in range(pool)]

    def make(k: int, i: int) -> None:
        out[k][i] = image(h, w, seed_sequence(seed, k, i))

    with ThreadPoolExecutor(min(n * pool, GEN_THREADS)) as ex:
        for f in [ex.submit(make, k, i)
                  for k in range(pool) for i in range(n)]:
            f.result()
    return out


def check_mix(mix: dict, name: str, own_keys: set[str] = frozenset()) -> dict:
    """Refuse a mix file with unknown keys or bad counts; ``own_keys`` are
    the parameters its ``sends`` and ``loop`` files read."""
    extra = set(mix) - MIX_KEYS - set(own_keys)
    if extra:
        raise ValueError(f"mix {name}: unknown keys {sorted(extra)}")
    if int(mix.get("pool", 0)) < 1:
        raise ValueError(f"mix {name}: 'pool' must be at least 1")
    if int(mix.get("check_every", 0)) < 1:
        raise ValueError(f"mix {name}: 'check_every' must be at least 1")
    return mix
