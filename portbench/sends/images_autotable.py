"""Each item is one input of the pool as it is, a (1, H, W) uint8 batch of
one image.  The answer expected is its stream with Huffman tables built
for the image, equal byte for byte to ``reference_torch/autotable.py``'s
(written from the definition of the tables in its docstring).
The configuration's own precision decides the reference, not the
control's override: it must be exact, with the TICX index."""

from portbench import compare
from portbench.reference_torch import autotable

KEYS = set()
check = compare.streams
same = compare.same_streams


def make(pool, config, mix):
    """As ``sends/images.py``; refuses a configuration that is not exact or
    has no index."""
    if config["precision"] != "exact" or not config["block_index"]:
        raise ValueError("images_autotable answers exact precision with "
                         "block_index true only")

    def expected():
        ref = autotable.encode_pool(pool, config["quality"],
                                    config["index_stride"])
        return ref, [sum(map(len, s)) for s in ref]

    return pool, 0.0, expected
