"""The host-entropy decode leg's batch entry point on the CPU:
``native.entropy_decode_batch`` (``tic_entropy_decode_batch``) writes a
batch's streams straight into the narrow upload form (int16 DC, int8 AC
and each stream's outliers), or int16 AC where a stream cannot go narrow.
Widened back to int32, the rows must equal ``np.stack`` of
``container.decompress_to_arrays(d, index_workers=1)`` on every kind of
stream: no trailer, outliers past int8, custom tables, TICX trailers (a
valid one over a corrupt payload, one that lies), truncated and
bit-flipped streams, a batch of one, and the batches that go wide."""

import struct

import numpy as np
import pytest
import torch

from tinyimgcodec_tpu_torch import container, native
from tinyimgcodec_tpu_torch.engine import (
    Engine, compact_coefficients, host_entropy_rows, join_outliers,
    widen_coefficients,
)
from tinyimgcodec_tpu_torch.golden import CodecArrays

from conftest import synthetic_image

IMGS = [synthetic_image(64, 64, seed=s) for s in (151, 152, 153, 154)]


def _flipped(data: bytes, seed: int, flips: int = 3,
             first: int = 16) -> bytes:
    """``data`` with ``flips`` random bits of its payload flipped, as
    ``tests/test_fuzz.py`` corrupts streams."""
    rng = np.random.RandomState(seed)
    mut = bytearray(data)
    for _ in range(flips):
        i = rng.randint(first, len(mut))
        mut[i] ^= 1 << rng.randint(0, 8)
    return bytes(mut)


def _payload_end(data: bytes) -> int:
    return container.parse_block_index(data, 64)[2]


def _corrupt_indexed(data: bytes, seed: int) -> bytes:
    """A TICX stream whose trailer still validates, over a payload with
    bits flipped (the trailer's bytes untouched)."""
    end = _payload_end(data)
    head = _flipped(data[:end], seed, flips=4, first=40)
    out = head + data[end:]
    assert container.parse_block_index(out, 64) is not None
    return out


def _lying_trailer(data: bytes) -> bytes:
    """A TICX stream whose second chunk offset is past the payload: the
    trailer is refused and the serial cursor reads the whole stream."""
    mut = bytearray(data)
    (body_len,) = struct.unpack_from("<I", mut, len(mut) - 8)
    struct.pack_into("<I", mut, len(mut) - 8 - body_len + 12, 0xFFFFFFFF)
    assert container.parse_block_index(bytes(mut), 64) is None
    return bytes(mut)


def _dense(seed: int) -> bytes:
    """Hand-made coefficients, |AC| up to 1023 in most places: far more
    than an eighth of the AC outside int8, so the stream's list
    overflows."""
    rng = np.random.RandomState(seed)
    return container.compress_arrays(CodecArrays(
        64, 64, 50, rng.randint(-40, 41, 64).astype(np.int32),
        rng.randint(-1023, 1024, (64, 63)).astype(np.int32)))


def _fifteen_bit() -> bytes:
    """A custom-table stream with AC values of 15 bits: 32700 is 32768
    from its int8 wrap, a delta int16 cannot hold."""
    ac = np.zeros((64, 63), np.int32)
    ac[5, 7], ac[9, 0], ac[3, 3] = 32700, -32767, 300
    return container.compress_arrays(
        CodecArrays(64, 64, 50, np.zeros(64, np.int32), ac), True)


def _case(name: str) -> tuple[list[bytes], bool]:
    """The streams of a case (all 64x64, quality 50 unless said) and
    whether the batch has to go up as int16."""
    std = [container.compress(im, 50) for im in IMGS]
    if name == "no_trailer_q50":
        return std, False
    if name == "no_trailer_q95":
        return [container.compress(im, 95) for im in IMGS], False
    if name == "custom_table":
        return [std[0], container.compress(IMGS[1], 50, True), std[2],
                container.compress(IMGS[3], 50, True, block_index=True,
                                   index_stride=16)], False
    if name == "indexed":
        ticx = [container.compress(im, 50, block_index=True,
                                   index_stride=16) for im in IMGS]
        return [ticx[0], _corrupt_indexed(ticx[1], 5), _lying_trailer(
            ticx[2]), container.compress(IMGS[3], 50, block_index=True)
                ], False
    if name == "truncated":
        return [std[0][:len(std[0]) // 2], std[1][:17], std[2][:16],
                std[3][:len(std[3]) - 3]], False
    if name == "bit_flipped":
        auto = container.compress(IMGS[1], 50, True)
        return [_flipped(std[0], 1), _flipped(auto, 2, first=60),
                _flipped(std[2], 3, flips=8), std[3]], False
    if name == "one":
        return [container.compress(IMGS[0], 95)], False
    if name == "wide_overflow":
        return [std[0], _dense(7), std[2]], True
    if name == "wide_delta":
        return [std[0], _fifteen_bit()], True
    raise KeyError(name)


CASES = ["no_trailer_q50", "no_trailer_q95", "custom_table", "indexed",
         "truncated", "bit_flipped", "one", "wide_overflow", "wide_delta"]


def _want(streams):
    arrays = [container.decompress_to_arrays(d, index_workers=1)
              for d in streams]
    return (np.stack([a.dc for a in arrays]),
            np.stack([a.ac for a in arrays]))


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("case", CASES)
def test_the_batch_rows_widen_to_decompress_to_arrays(case, workers):
    streams, wide = _case(case)
    plans = [container.payload_plan(d) for d in streams]
    rows = native.entropy_decode_batch(plans, 1, workers)
    assert rows.dc.dtype == np.int16 and rows.ac.dtype == np.int8
    assert bool((rows.counts < 0).any()) == wide
    if wide:
        rows = native.entropy_decode_batch(plans, 2, workers)
        assert rows.ac.dtype == np.int16 and not rows.counts.any()
    dc, ac = _want(streams)
    narrow = join_outliers(rows)
    assert narrow[1].dtype == (np.int16 if wide else np.int8)
    assert narrow[2].dtype == np.int64 and narrow[3].dtype == np.int16
    got = widen_coefficients(*(torch.from_numpy(x) for x in narrow), "cpu")
    assert np.array_equal(got.numpy(),
                          np.concatenate([dc[..., None], ac], axis=-1))
    if not wide:  # the very form compact_coefficients gives
        for g, w in zip(narrow, compact_coefficients(dc, ac)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    if case == "no_trailer_q95":
        assert narrow[2].size > 0 and int(np.abs(ac).max()) > 127
    # the engine's stage: the same rows, decoded again as int16 if wide
    theirs = host_entropy_rows(streams)
    assert np.array_equal(theirs.counts, rows.counts)
    for mine, its in zip(narrow, join_outliers(theirs)):
        assert mine.dtype == its.dtype and np.array_equal(mine, its)


@pytest.mark.parametrize("case", ["indexed", "truncated", "bit_flipped",
                                  "custom_table", "wide_overflow"])
def test_the_leg_gives_the_oracles_pixels(case):
    """Every stream through the host-entropy leg (``device_entropy=False``
    sends the indexed ones there too): the pixels of
    ``container.decompress``, corrupt streams included."""
    streams, _ = _case(case)
    eng = Engine("exact", "cpu", device_entropy=False)
    got = eng.decompress_batch(streams)
    assert eng.decode_stats == {"kernel": 0, "host_entropy": len(streams),
                                "host_decoder": 0}
    assert np.array_equal(got,
                          np.stack([container.decompress(d) for d in streams]))


def test_an_overflowing_list_is_counted_past_its_room():
    """A stream's list holds ``nb * 63 // 8`` outliers; past that the
    count says -1, and the int8 rows are still the wrapped values."""
    data = _dense(8)
    plan = container.payload_plan(data)
    rows = native.entropy_decode_batch([plan], 1, 1)
    assert rows.idx.shape == (1, 64 * 63 // 8)
    assert rows.counts.tolist() == [-1]
    _, ac = _want([data])
    assert np.array_equal(rows.ac, ac.astype(np.int8))


def test_a_header_only_stream_decodes_to_zero_rows():
    data = container.compress(IMGS[0], 50)[:16]
    rows = native.entropy_decode_batch([container.payload_plan(data)], 1, 1)
    assert not rows.dc.any() and not rows.ac.any()
    assert rows.counts.tolist() == [0]


def test_the_batch_refuses_mixed_block_counts_and_unknown_widths():
    plans = [container.payload_plan(container.compress(im, 50))
             for im in (IMGS[0], synthetic_image(64, 72, seed=155))]
    with pytest.raises(ValueError, match="different block counts"):
        native.entropy_decode_batch(plans)
    with pytest.raises(ValueError, match="width 4"):
        native.entropy_decode_batch(plans[:1], 4)
