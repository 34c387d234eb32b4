"""Each item is one input of the pool as it is, a (B, H, W) uint8 batch of
the configuration's images.  The answer expected is one stream an image,
equal byte for byte to the reference encoder's."""

from portbench import compare
from portbench.reference import codec

KEYS = set()
check = compare.streams
same = compare.same_streams


def make(pool, config, mix):
    """(items, seconds of reference work spent here, expected): the items
    the window sends, and a function that gives, after the window, the
    expected answer of each item and the bytes of its streams."""

    def expected():
        ref = codec.encode_pool(pool, config["quality"],
                                config["index_stride"])
        return [s for s, _ in ref], [sum(map(len, s)) for s, _ in ref]

    return pool, 0.0, expected
