"""Stream assembly from ragged block rows (the v1 path's second kernel):
the port's plain version (the CUDA kernel's twin, bit for bit) vs the JAX
package's Pallas bit writer in interpret mode.  Every JAX case has N = 128
blocks, nb = 64; the JAX side compiles once per capacity.

The CUDA kernel is a gather over the output words after a look-back scan
(``csrc/stitch.cu``); :func:`stitch_model` below is that kernel's
arithmetic in plain Python -- spans of blocks, the scan of runs, the look
back, word ownership, bisection, the next span's offsets computed by the
owner -- held against the plain version, the JAX package and streams
built bit by bit."""

import functools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import golden as jgolden
from tinyimgcodec_tpu.constants import ZIGZAG_ORDER
from tinyimgcodec_tpu.ops import transform as jtransform
from tinyimgcodec_tpu.ops.pallas_stitch import stitch_pallas
from tinyimgcodec_tpu_torch.corpus import blocks_of_random_bits
from tinyimgcodec_tpu_torch.ops import encode1, stitch as tst
from tinyimgcodec_tpu_torch.tables import CodecTables

from conftest import synthetic_image
from test_torch_encode2 import run_apply, run_then
from test_torch_place import _words_of

N, NB = 128, 64


@functools.cache
def _jax_stitch(cap):
    return jax.jit(lambda w, b: stitch_pallas(w, b, nb=NB, cap_words=cap,
                                              bt=64, interpret=True))


@functools.cache
def _encoded(quality=50):
    """(words (N, 52) int32, bits (N,) int32) of two natural images."""
    imgs = np.stack([synthetic_image(64, 64, seed=s) for s in (51, 52)])
    blocks = np.asarray(jtransform.blockify(imgs)).reshape(-1, 8, 8)
    co = jgolden.quantize(
        jgolden.block_dct(blocks.astype(np.float64) - 128.0), quality
    ).reshape(-1, 64)[:, ZIGZAG_ORDER].astype(np.int32)
    w, b, _ = encode1.encode1(torch.from_numpy(np.ascontiguousarray(co)),
                              CodecTables.build(quality, "cpu"), NB,
                              from_zz=True)
    return w, b


def _ragged(seed):
    """Random rows: bit counts anywhere in 6..1662, random bits below the
    count and zero above it."""
    rng = np.random.RandomState(seed)
    bits = rng.randint(6, 1663, N).astype(np.int32)
    bits[::5] = rng.randint(6, 40, len(bits[::5]))
    raw = rng.randint(0, 2, (N, 52 * 32)).astype(np.uint8)
    raw[np.arange(52 * 32)[None, :] >= bits[:, None]] = 0
    words = np.packbits(raw, axis=1).view(">u4").astype(np.uint32)
    return torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits)


def _both(words, bits, cap):
    sj, stj, tj, fj = _jax_stitch(cap)(
        words.numpy().view(np.uint32), bits.numpy())
    sm, stm, tm, fm = tst.stitch(words, bits, NB, cap)
    assert sm.shape == (cap,)
    mine = (sm.numpy().view(np.uint32), stm.numpy(), int(tm), int(fm))
    theirs = (np.asarray(sj)[:cap], np.asarray(stj), int(tj), int(fj))
    return mine, theirs


def _assert_equal(mine, theirs):
    assert mine[2] == theirs[2] and mine[3] == theirs[3]
    assert np.array_equal(mine[1], theirs[1]), "image starts differ"
    assert np.array_equal(mine[0], theirs[0]), "stream words differ"


def _total(bits):
    b = bits.numpy().astype(np.int64)
    first = int(b[:NB].sum())
    return (first + 7) // 8 * 8 + int(b[NB:].sum())


def test_roomy_capacity_equals_jax_and_is_the_concatenation():
    words, bits = _encoded()
    mine, theirs = _both(words, bits, 1024)
    _assert_equal(mine, theirs)
    assert mine[3] == 0 and mine[2] == _total(bits)
    # the stream is the rows' bits back to back, image 2 on a byte
    rows = np.unpackbits(
        words.numpy().view(np.uint32).astype(">u4").view(np.uint8)
        .reshape(N, -1), axis=1)
    want = []
    for b in range(N):
        if b == NB:
            want.extend([0] * (-len(want) % 8))
        want.extend(rows[b, : int(bits[b])])
    got = np.unpackbits(mine[0].astype(">u4").view(np.uint8))[: len(want)]
    assert np.array_equal(got, np.array(want, np.uint8))
    assert mine[1].tolist() == [0, (int(bits[:NB].sum()) + 7) // 8 * 8]


def test_capacity_exact_and_one_word_short():
    """At exactly ceil(total / 32) words nothing is lost and status is 0;
    one word less drops the last word (never moves it) and sets status 2."""
    words, bits = _encoded(90)
    total = _total(bits)
    exact = -(-total // 32)
    assert total % 32  # the last word is partial: the tail case
    mine, theirs = _both(words, bits, exact)
    _assert_equal(mine, theirs)
    assert mine[3] == 0
    short, theirs_short = _both(words, bits, exact - 1)
    _assert_equal(short, theirs_short)
    assert short[3] == 2 and short[2] == total
    assert np.array_equal(short[0], mine[0][: exact - 1])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_ragged_rows_equal_jax(seed):
    words, bits = _ragged(seed)
    cap = 128 * 52
    mine, theirs = _both(words, bits, cap)
    _assert_equal(mine, theirs)
    assert mine[3] == 0


def test_far_too_small_capacity_drops_and_flags():
    words, bits = _ragged(4)
    cap = 128
    full = tst.stitch(words, bits, NB, 128 * 52)
    got = tst.stitch(words, bits, NB, cap)
    assert int(got[3]) == 2 and int(got[2]) == int(full[2])
    assert torch.equal(got[0], full[0][:cap])
    assert torch.equal(got[1], full[1])


def test_wrapper_validates_and_counts_no_launch_on_cpu():
    words, bits = _encoded()
    before = tst.launches
    tst.stitch(words, bits, NB, 512)
    assert tst.launches == before
    with pytest.raises(ValueError):
        tst.stitch(words[:, :50].contiguous(), bits, NB, 512)
    with pytest.raises(ValueError):
        tst.stitch(words, bits[:-1], NB, 512)
    with pytest.raises(ValueError):
        tst.stitch(words, bits, 48, 512)
    with pytest.raises(ValueError):
        tst.stitch(words, bits, NB, 0)


def test_refuses_more_blocks_than_an_int32_bit_cursor_holds():
    # 2**31 bits / (52 words * 32 bits) blocks: views, no memory behind them
    n = -(-(1 << 31) // (52 * 32))
    words = torch.zeros((1, 52), dtype=torch.int32).expand(n, 52)
    bits = torch.zeros((1,), dtype=torch.int32).expand(n)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tst.stitch(words, bits, 1, 1 << 20)
    tst._check(words[: n - 1], bits[: n - 1], 1, 1 << 20)


# ---- the CUDA kernel's gather, in plain Python -----------------------------


def _block_run(nbits, starts):
    """What one block does to the running offset: align8 if it starts an
    image, then + its bits."""
    return (1, 0, nbits) if starts else (0, nbits, 0)


def stitch_model(words, bits, nb, cap, span, resolved=None):
    """What ``stitch_kernel`` computes, span by span and thread by thread.

    A span of ``span`` blocks scans what its blocks do to the running
    offset (runs, composed in order), publishes the composition, and takes
    its starting offset from the spans before it by looking back to the
    nearest one that ``resolved(j)`` says already knows its end (span -1,
    the stream's start, always does).  It owns the words whose first bit
    lies at or after its first block's offset and before the next span's;
    a word is the OR of the funnel-shifted row words of every block from
    the first whose end lies past the word's first bit (bisection) to the
    last that begins inside the word, the blocks past the span with
    offsets computed by the owner from its own end.  Words from the
    stream's end to ``cap`` are zeros.  Asserts that every word below
    ``cap`` is stored exactly once.  Returns (stream, starts, total,
    status) and the largest number of blocks met in one word."""
    rows = words.numpy().view(np.uint32)
    bl = bits.numpy().astype(np.int64)
    n = bl.shape[0]
    aggregates, ends, spans = [], [], []
    for g, b0 in enumerate(range(0, n, span)):
        live = min(span, n - b0)
        excl, acc = [], (0, 0, 0)
        for i in range(live):
            excl.append(acc)
            acc = run_then(acc, _block_run(int(bl[b0 + i]), (b0 + i) % nb == 0))
        aggregates.append(acc)
        back = (0, 0, 0)
        for j in range(g - 1, -2, -1):
            if j < 0 or resolved is None or resolved(j):
                at = run_apply(back, 0 if j < 0 else ends[j])
                break
            back = run_then(aggregates[j], back)
        ends.append(run_apply(acc, at))
        spans.append((b0, live, excl, at))
    total = ends[-1]
    stream = np.full(cap, 0xDEADBEEF, np.uint32)
    stores = np.zeros(cap, np.int64)
    starts = np.zeros(n // nb, np.int64)
    most = 0
    for g, (b0, live, excl, at) in enumerate(spans):
        off = []
        for i in range(live):
            pos = run_apply(excl[i], at)
            off.append((pos + 7) & ~7 if (b0 + i) % nb == 0 else pos)
            if (b0 + i) % nb == 0:
                starts[(b0 + i) // nb] = off[i]
        end = np.array(off) + bl[b0:b0 + live]
        nx = b0 + live
        nxt = (ends[g] + 7) & ~7 if nx < n and nx % nb == 0 else ends[g]
        first = 0 if g == 0 else (off[0] + 31) >> 5
        for t in range(first, min((nxt + 31) >> 5, cap)):
            lo = 32 * t
            i = int(np.searchsorted(end, lo, "right"))
            acc, pos, met = 0, ends[g], 0
            while b0 + i < n:
                b = b0 + i
                if i < live:
                    o = off[i]
                else:
                    o = (pos + 7) & ~7 if b % nb == 0 else pos
                    pos = o + int(bl[b])
                if o >= lo + 32:
                    break
                sh, j = o & 31, t - (o >> 5)
                if j < (sh + int(bl[b]) + 31) >> 5:
                    cur = int(rows[b, j]) if j < 52 else 0
                    prev = int(rows[b, j - 1]) if 0 < j <= 52 else 0
                    acc |= (((prev << 32) | cur) >> sh) & 0xFFFFFFFF
                    met += 1
                i += 1
            stream[t] = acc
            stores[t] += 1
            most = max(most, met)
    used = min((total + 31) >> 5, cap)
    stream[used:] = 0
    stores[used:] += 1
    assert (stores == 1).all(), "a word with no owner or with two"
    status = 2 if total > cap * 32 else 0
    return (stream, starts, total, status), most


def _model_equals_plain(words, bits, nb, cap, span, resolved=None):
    (sm, stm, totm, stam), most = stitch_model(words, bits, nb, cap, span,
                                               resolved)
    sp, stp, totp, stap = tst.stitch_plain(words, bits, nb, cap)
    assert np.array_equal(sm, sp.numpy().view(np.uint32))
    assert np.array_equal(stm, stp.numpy())
    assert totm == int(totp) and stam == int(stap)
    return sm, most


def _handmade(image_bits, seed):
    w, meta, nb, stream_bits = blocks_of_random_bits(image_bits, seed,
                                                     from_bit0=True)
    return (torch.from_numpy(w.view(np.int32)), torch.from_numpy(meta[1]),
            nb, stream_bits)


HANDMADE = {
    # every block is an image start
    "one-block-images": [[int(b)] for b in
                         np.random.RandomState(3).randint(2, 90, 40)],
    # six blocks of the shortest standard length meet in a word
    "six-bit-blocks": [[6] * 16] * 3,
    # nothing builds that number in: sixteen blocks a word
    "two-bit-blocks": [[2] * 40] * 2,
    # the longest block a row holds at phase 0, then at phase 31
    "longest-at-phases-0-and-31": [[1662, 6, 27, 1664, 6, 6, 6, 9]] * 2,
    # three images whose pad bits share words with both neighbours
    "pads-share-words": [[6, 6, 5, 2], [6, 3, 7, 1], [2, 2, 2, 3]],
    "one-block": [[13]],
}
SPANS = [1, 5, 64, 256]
ORDERS = {"all-resolved": None, "none-resolved": lambda j: False}


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("case", sorted(HANDMADE))
def test_gather_model_on_handmade_rows(case, span, order):
    words, bits, nb, stream_bits = _handmade(HANDMADE[case], len(case))
    fits = -(-len(stream_bits) // 32)
    if case.startswith("longest"):
        off = tst.image_offsets(bits.to(torch.int64), nb)[0]
        assert {int(o) & 31 for o, c in zip(off, bits) if c >= 1662} >= {0, 31}
    for cap in (fits, max(fits - 1, 1), 10 * fits):
        got, most = _model_equals_plain(words, bits, nb, cap, span,
                                        ORDERS[order])
        assert np.array_equal(got, _words_of(stream_bits, cap))
    if case == "two-bit-blocks":
        assert most == 16


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("content", ["natural", "dense", "ragged"])
def test_gather_model_on_encoded_rows(content, span):
    """The file's own shapes, N = 128 and nb = 64: an image start inside
    every span wider than 64 blocks, words shared across span boundaries,
    looked back over with a random mix of resolved spans."""
    words, bits = {"natural": _encoded, "dense": lambda: _encoded(90),
                   "ragged": lambda: _ragged(1)}[content]()
    total = _total(bits)
    fits = -(-total // 32)
    pick = np.random.RandomState(span)
    resolved = lambda j: bool(pick.randint(0, 3) == 0)  # noqa: E731
    for cap in (fits, fits - 1, 1024, N * 52):
        _model_equals_plain(words, bits, NB, cap, span, resolved)


def test_gather_model_equals_the_jax_kernel():
    """The model against the JAX bit writer at the capacities the file
    already compiles for."""
    for (words, bits), cap in ((_encoded(), 1024), (_ragged(2), N * 52)):
        mine, theirs = _both(words, bits, cap)
        (sm, stm, totm, stam), _ = stitch_model(words, bits, NB, cap, 5)
        _assert_equal((sm, stm, totm, stam), theirs)
        _assert_equal(mine, theirs)


def test_wrapper_span_matches_the_kernel_source():
    src = (Path(tst.__file__).resolve().parent.parent / "csrc" / "stitch.cu")
    assert re.search(r"constexpr int THREADS = (\d+);", src.read_text()
                     ).group(1) == str(tst.SPAN)
    assert "constexpr int SPAN = THREADS;" in src.read_text()
