"""Each item is the reference encoder's streams of one input of the pool,
made in set-up, so that decode traffic does not move with the program's
encoder.  The answer expected is the (B, H, W) uint8 pixels of the
reference's inverse transform of its own coefficients, pixel for pixel."""

import time

from portbench import compare
from portbench.reference import codec

KEYS = set()
check = compare.pixels
same = compare.same_pixels


def make(pool, config, mix):
    """As ``sends/images.py``; the streams are the reference's work, and
    their seconds are given apart so that ``setup_s`` leaves them out."""
    t = time.perf_counter()
    ref = codec.encode_pool(pool, config["quality"], config["index_stride"])
    ref_s = time.perf_counter() - t
    items = [s for s, _ in ref]

    def expected():
        pixels = [codec.decode_pixels(c, config["height"], config["width"],
                                      config["quality"]) for _, c in ref]
        return pixels, [sum(map(len, s)) for s in items]

    return items, ref_s, expected
