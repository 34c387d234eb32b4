"""Each item is the reference encoder's streams of one input of the pool
with no index, the upstream project's own format: a 16-byte header and the
packed payload, nothing after it.  They are the reference's TICX streams
with each trailer cut by its own fields, made in set-up, so that decode
traffic does not move with the program's encoder.  The answer expected is
the (B, H, W) uint8 pixels of the reference's inverse transform of its own
coefficients, pixel for pixel."""

import struct
import time

from portbench import compare
from portbench.reference import codec
from portbench.reference.tables import INDEX_MAGIC

HEADER_BYTES = 16
KEYS = set()
check = compare.pixels
same = compare.same_pixels


def cut_trailer(stream: bytes) -> bytes:
    """A TICX-indexed stream without its trailer: the last 4 bytes are the
    magic, the 4 before them the body's length; body, length and magic go.
    A stream that does not end in the magic raises ``ValueError``."""
    if stream[-4:] != INDEX_MAGIC:
        raise ValueError("stream does not end in a TICX trailer")
    end = len(stream) - 8 - struct.unpack("<I", stream[-8:-4])[0]
    if end < HEADER_BYTES:
        raise ValueError("TICX trailer longer than its stream")
    return stream[:end]


def make(pool, config, mix):
    """As ``sends/reference_streams.py``, with each trailer cut; refuses a
    configuration with ``block_index`` true.  The reference's seconds are
    given apart, so that ``setup_s`` leaves them out."""
    if config["block_index"]:
        raise ValueError("reference_streams_noindex answers block_index "
                         "false only")
    t = time.perf_counter()
    ref = codec.encode_pool(pool, config["quality"], config["index_stride"])
    items = [[cut_trailer(s) for s in streams] for streams, _ in ref]
    ref_s = time.perf_counter() - t

    def expected():
        pixels = [codec.decode_pixels(c, config["height"], config["width"],
                                      config["quality"]) for _, c in ref]
        return pixels, [sum(map(len, s)) for s in items]

    return items, ref_s, expected
