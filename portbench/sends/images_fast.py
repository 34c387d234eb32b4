"""Each item is one input of the pool as it is, a (B, H, W) uint8 batch of
the configuration's images, for a configuration of fast precision.  The
answer expected is one stream an image, equal byte for byte to the float32
reference's (``reference_torch/fast.py``: the encode kernel's ascending
order, which defines fast mode's bytes).  The configuration's own
precision decides the reference, not the control's override, so a run of
the program in exact mode is refused."""

from portbench import compare
from portbench.reference_torch import fast

KEYS = set()
check = compare.streams
same = compare.same_streams


def make(pool, config, mix):
    """As ``sends/images.py``; refuses a configuration that is not of
    fast precision."""
    if config["precision"] != "fast":
        raise ValueError(f"images_fast answers fast precision only, not "
                         f"{config['precision']!r}")

    def expected():
        ref = fast.encode_pool(pool, config["quality"],
                               config["index_stride"])
        return [s for s, _ in ref], [sum(map(len, s)) for s, _ in ref]

    return pool, 0.0, expected
