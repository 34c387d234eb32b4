"""A corrupt log2-stride byte of the TICX trailer, on the CPU: every value
0-255 decodes, through the port's ``decompress`` (the plain version of the
entropy decode kernel), to the float64 oracle's pixels and to the JAX
package's.

A one-chunk image passes the trailer's chunk-count check for any stride at
or above its block count, 2**255 included; the port's ``prepare_batch``
takes the image's block count as the stride of such an image where the
stride passes int32.
"""

import struct

import numpy as np
import pytest

import tinyimgcodec_tpu as jtic
import tinyimgcodec_tpu_torch as ttic
from tinyimgcodec_tpu_torch import container
from tinyimgcodec_tpu_torch.engine import Engine
from tinyimgcodec_tpu_torch.ops.entropy_decode import prepare_batch

from conftest import synthetic_image

SHAPES = [(1, 40), (16, 16), (40, 40)]


def _stream(shape) -> bytes:
    return container.compress(synthetic_image(*shape, seed=sum(shape)), 60,
                              block_index=True)


def _with_stride_byte(data: bytes, value: int) -> bytes:
    """``data`` with its trailer's log2-stride byte set to ``value``."""
    (body_len,) = struct.unpack_from("<I", data, len(data) - 8)
    at = len(data) - 8 - body_len + 1
    return data[:at] + bytes([value]) + data[at + 1:]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_stride_byte_decodes_to_the_oracle(shape):
    """The 256 streams in two batches: those whose trailer still counts
    one chunk (a stride at or above the block count) on the kernel leg,
    the others, whose trailer is refused, on the host-entropy leg; the
    pixels of each == ``container.decompress``'s == the JAX package's."""
    clean = _stream(shape)
    nb = -(-shape[0] // 8) * -(-shape[1] // 8)
    assert container.parse_block_index(clean, nb)[1] == container.INDEX_STRIDE
    eng = Engine("exact", "cpu")
    assert np.array_equal(eng.decompress(clean), container.decompress(clean))
    assert eng.decode_stats == {"kernel": 1, "host_entropy": 0,
                                "host_decoder": 0}
    assert prepare_batch([clean])["stride"] == container.INDEX_STRIDE
    first = (nb - 1).bit_length()  # the least log2 stride of one chunk
    streams = [_with_stride_byte(clean, v) for v in range(256)]
    for v, data in enumerate(streams):
        prep = prepare_batch([data])
        assert (prep is not None) == (v >= first), v
        if prep is not None:
            assert prep["stride"] == (1 << v if v <= 31 else nb), v
            assert list(prep["chunk_blocks"]) == [nb]
        assert np.array_equal(jtic.decompress(data),
                              container.decompress(data)), v
    # the kernel leg takes a batch of one stride: a stream a batch up to
    # 2**31, one batch of the strides past it; the refused trailers take
    # the host-entropy leg, as one batch
    parts = [([s], "kernel") for s in streams[first:32]]
    parts += [(streams[32:], "kernel"), (streams[:first], "host_entropy")]
    for part, leg in parts:
        want = np.stack([container.decompress(s) for s in part])
        assert np.array_equal(eng.decompress_batch(part), want)
        assert eng.decode_stats[leg] == len(part)
    assert np.array_equal(ttic.decompress_batch(streams[32:], device="cpu"),
                          np.stack([container.decompress(s)
                                    for s in streams[32:]]))
    # one stream at a time through the public entry point, at the edges
    for v in (first - 1, first, 62, 63, 64, 255):
        data = streams[v]
        assert np.array_equal(ttic.decompress(data, device="cpu"),
                              container.decompress(data)), v


def test_a_batch_mixing_clean_and_corrupt_strides():
    """Corrupt strides past int32 share the block count as their stride,
    so they decode as one batch on the kernel leg; beside a clean stream
    the strides differ and the batch takes the host-entropy leg, with the
    oracle's pixels either way."""
    clean = _stream((40, 40))
    corrupt = [_with_stride_byte(clean, 200), _with_stride_byte(clean, 63)]
    eng = Engine("exact", "cpu")
    for batch, leg in ((corrupt, "kernel"),
                       ([clean, *corrupt], "host_entropy")):
        got = eng.decompress_batch(batch)
        assert np.array_equal(got, np.stack([container.decompress(s)
                                             for s in batch]))
        assert eng.decode_stats[leg] == len(batch)
