"""Word placement: the port's plain version (the CUDA kernel's twin) vs
the JAX package's ``assemble_cm`` in interpret mode under each of its
three routings (bt=64: the v4 matmul scatter with the v3 masked roll
behind a cond; bt=8: the v2 delta chain).

The CUDA kernel is a gather over the output words (``csrc/place.cu``);
:func:`gather_model` below is that kernel's arithmetic in plain Python --
spans of blocks, word ownership, bisection in the block ends, the walk
over the covering blocks -- held against the plain version, against the
JAX package and against streams built bit by bit."""

import functools

import jax
import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import container as jcontainer
from tinyimgcodec_tpu.ops.pallas_place import assemble_cm
from tinyimgcodec_tpu_torch.corpus import blocks_of_random_bits
from tinyimgcodec_tpu_torch.ops import encode2 as tenc
from tinyimgcodec_tpu_torch.ops import place as tplace
from tinyimgcodec_tpu_torch.ops import transform as ttransform
from tinyimgcodec_tpu_torch.pipeline import exact_coefficients
from tinyimgcodec_tpu_torch.tables import CodecTables

from conftest import synthetic_image


def _encoded(imgs: np.ndarray, quality: int):
    """Encode-kernel outputs (port's plain version; held equal to the JAX
    kernel's in test_torch_encode2.py) for a (B, H, W) batch."""
    t = CodecTables.build(quality, "cpu")
    blocks = ttransform.blockify(torch.from_numpy(imgs)).reshape(-1, 64)
    zz = exact_coefficients(blocks, t)
    nb = blocks.shape[0] // imgs.shape[0]
    packed, meta, over = tenc.encode2(zz, t, nb, from_zz=True)
    assert not bool(over)
    return packed, meta, nb


@functools.cache
def _jax_place(nb, cap_words, bt):
    """Jitted like the JAX pipeline's own stage: compiled once a routing."""
    return jax.jit(functools.partial(
        assemble_cm, nb=nb, cap_words=cap_words, bt=bt, interpret=True
    ))


def _compare(packed, meta, nb, cap_words, bt):
    sj, stj, totj, ovj = _jax_place(nb, cap_words, bt)(
        packed.numpy().view(np.uint32), meta.numpy().view(np.uint32)
    )
    st, stt, tott, ovt = tplace.place(packed, meta, nb, cap_words)
    assert st.shape == (cap_words,) and st.dtype == torch.int32
    assert int(tott) == int(totj)
    assert bool(ovt) == bool(ovj)
    assert np.array_equal(stt.numpy(), np.asarray(stj))
    nwords = min(-(-int(tott) // 32), cap_words)
    mine = st.numpy().view(np.uint32)
    assert np.array_equal(mine[:nwords], np.asarray(sj)[:nwords])
    assert not mine[nwords:].any()
    return mine, int(tott), bool(ovt)


NATURAL = np.stack([synthetic_image(64, 64, seed=s) for s in (51, 52)])
NOISE = np.random.RandomState(13).randint(0, 256, (2, 64, 64)).astype(np.uint8)


@pytest.mark.parametrize("bt", [64, 8])
def test_natural_content_equal(bt):
    packed, meta, nb = _encoded(NATURAL, 50)
    _compare(packed, meta, nb, 2 * 64 * 64 * 4 // 32, bt)


@pytest.mark.parametrize("bt", [64, 8])
def test_dense_noise_equal(bt):
    packed, meta, nb = _encoded(NOISE, 90)
    _compare(packed, meta, nb, 128 * 52, bt)


def test_capacity_overflow_is_flagged_exactly():
    packed, meta, nb = _encoded(NOISE, 90)
    total = int(meta[0, -1]) + int(meta[1, -1])
    fits = -(-total // 32)
    for cap, expect in ((fits, False), (fits - 1, True), (1024, True)):
        out = tplace.place(packed, meta, nb, cap)
        assert bool(out[3]) == expect
        assert int(out[2]) == total
    # the JAX package flags the same budget
    _, _, _, ovj = _jax_place(nb, 1024, 64)(
        packed.numpy().view(np.uint32), meta.numpy().view(np.uint32)
    )
    assert bool(ovj)


def test_tail_in_the_last_row_of_the_budget_is_not_relocated():
    """64x64 noise at quality 50 under a 4 bpp budget ends in the final
    128-word row of the budget; a clamp of the target word once moved such
    blocks onto earlier data.  Words beyond the allocation are dropped and
    everything before it is exactly the oracle's payload."""
    img = np.random.RandomState(0).randint(0, 256, (64, 64)).astype(np.uint8)
    packed, meta, nb = _encoded(img[None], 50)
    cap = 64 * 64 * 4 // 32
    mine, total, over = _compare(packed, meta, nb, cap, 64)
    assert not over and total > (cap - 128) * 32
    payload = jcontainer.compress(img, 50)[16:]
    assert mine.astype(">u4").tobytes()[: -(-total // 8)] == payload
    # one word short: flagged, and the words that do fit are untouched
    short = tplace.place(packed, meta, nb, -(-total // 32) - 1)
    assert bool(short[3])
    k = short[0].shape[0]
    assert np.array_equal(short[0].numpy().view(np.uint32), mine[:k])


def test_wrapper_validates_and_counts_no_launch_on_cpu():
    packed, meta, nb = _encoded(NATURAL, 50)
    before = tplace.launches
    tplace.place(packed, meta, nb, 1024)
    assert tplace.launches == before
    with pytest.raises(ValueError):
        tplace.place(packed, meta, 48, 1024)
    with pytest.raises(ValueError):
        tplace.place(packed.to(torch.int64), meta, nb, 1024)


# ---- the CUDA kernel's gather, in plain Python -----------------------------


def gather_model(packed, meta, nb, cap, span):
    """What ``place_kernel`` computes, CTA by CTA and thread by thread.  A
    CTA stages ``span`` consecutive blocks and owns the words whose first
    bit lies at or after its first block's offset and before the next
    span's; a word is the OR of row word ``t - (offset >> 5)`` of every
    block from the first whose end lies past the word's first bit to the
    last that begins inside the word.  Asserts that every word below
    ``cap`` is stored exactly once."""
    rows = packed.numpy().view(np.uint32)
    off = meta[0].numpy().astype(np.int64)
    end = off + meta[1].numpy()
    n = off.shape[0]
    total = int(end[-1])
    stream = np.full(cap, 0xDEADBEEF, np.uint32)
    stores = np.zeros(cap, np.int64)
    for b0 in range(0, n, span):
        live = min(span, n - b0)
        nxt = int(off[b0 + live]) if b0 + live < n else total
        first = 0 if b0 == 0 else (int(off[b0]) + 31) >> 5
        last = min((nxt + 31) >> 5, cap)
        for t in range(first, last):
            lo = 32 * t
            # least i of the span with end[i] > lo, or live
            b = b0 + int(np.searchsorted(end[b0:b0 + live], lo, "right"))
            acc = 0
            while b < n and off[b] < lo + 32:
                j = t - (int(off[b]) >> 5)
                if j < 56:
                    acc |= int(rows[b, j])
                b += 1
            stream[t] = acc
            stores[t] += 1
    used = min((total + 31) >> 5, cap)
    stream[used:] = 0
    stores[used:] += 1
    assert (stores == 1).all(), "a word with no owner or with two"
    return stream, off[::nb], total, total > cap * 32


SPANS = [1, 5, 64, 256]


def _model_equals_plain(packed, meta, nb, cap, span):
    sm, stm, totm, ovm = gather_model(packed, meta, nb, cap, span)
    sp, stp, totp, ovp = tplace.place_plain(packed, meta, nb, cap)
    assert np.array_equal(sm, sp.numpy().view(np.uint32))
    assert np.array_equal(stm, stp.numpy())
    assert totm == int(totp) and ovm == bool(ovp)
    return sm


def _handmade(image_bits, seed=0):
    """:func:`blocks_of_random_bits` as tensors, and the stream built bit
    by bit."""
    packed, meta, nb, stream_bits = blocks_of_random_bits(image_bits, seed)
    return (torch.from_numpy(packed.view(np.int32)), torch.from_numpy(meta),
            nb, stream_bits)


def _words_of(stream_bits, cap):
    padded = np.zeros(max(cap, -(-len(stream_bits) // 32)) * 32, np.uint8)
    padded[:len(stream_bits)] = stream_bits
    return np.packbits(padded).view(">u4").astype(np.uint32)[:cap]


HANDMADE = {
    # six blocks of the shortest standard length meet in a word
    "six-bit-blocks": [[6] * 16] * 3,
    # nothing builds that number in: sixteen blocks a word
    "two-bit-blocks": [[2] * 40] * 2,
    # the longest legal block at phase 0, then at phase 31 (53 words of 56)
    "longest-at-phases-0-and-31": [[1662, 6, 27, 1662, 6, 6, 6, 9]] * 2,
    # three images whose pad bits share words with both neighbours
    "pads-share-words": [[6, 6, 5, 2], [6, 3, 7, 1], [2, 2, 2, 3]],
    "one-block": [[13]],
    # a block that begins and ends inside a word next to five others, and
    # span boundaries (span 5) that fall on image boundaries (nb 5)
    "image-boundary-on-span-boundary": [[6, 6, 7, 6, 6], [40, 3, 6, 6, 70],
                                        [6, 1662, 6, 6, 6]],
}


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("case", sorted(HANDMADE))
def test_gather_model_on_handmade_meta(case, span):
    packed, meta, nb, bits = _handmade(HANDMADE[case], seed=len(case))
    fits = -(-len(bits) // 32)
    if case.startswith("longest"):
        assert {int(o) & 31 for o, c in zip(meta[0], meta[1])
                if c == 1662} >= {0, 31}
    for cap in (fits, max(fits - 1, 1), 10 * fits):
        got = _model_equals_plain(packed, meta, nb, cap, span)
        assert np.array_equal(got, _words_of(bits, cap))
        assert bool(tplace.place(packed, meta, nb, cap)[3]) == (cap < fits)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("content", ["natural", "noise"])
def test_gather_model_on_encoded_content(content, span):
    imgs, quality = (NATURAL, 50) if content == "natural" else (NOISE, 90)
    packed, meta, nb = _encoded(imgs, quality)
    total = int(meta[0, -1]) + int(meta[1, -1])
    fits = -(-total // 32)
    for cap in (fits, fits - 1, imgs.size * 4 // 32, 128 * 52):
        _model_equals_plain(packed, meta, nb, cap, span)


@pytest.mark.parametrize("case", ["six-bit-blocks",
                                  "longest-at-phases-0-and-31"])
def test_handmade_meta_equals_the_jax_kernel(case):
    packed, meta, nb, bits = _handmade(HANDMADE[case], seed=len(case))
    cap = -(-len(bits) // 32) + 3
    mine, total, over = _compare(packed, meta, nb, cap, 8)
    assert total == len(bits) and not over
    assert np.array_equal(mine, _words_of(bits, cap))
    assert np.array_equal(gather_model(packed, meta, nb, cap, 5)[0], mine)


def test_overflow_limit_does_not_wrap_at_32_bits():
    """``cap_words * 32`` passes 2**31 from 2**26 words on; the flag must
    stay false there (the kernel computes the limit in 64 bits, the plain
    version clamps it to what an int32 total can reach)."""
    packed, meta, nb, _ = _handmade(HANDMADE["one-block"])
    for cap in (1 << 26, (1 << 31) - 1):
        _, total, over = tplace._summary(meta, nb, cap)
        assert int(total) == 13 and not bool(over)
    assert bool(tplace._summary(meta, nb, 0)[2])
