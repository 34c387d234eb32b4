"""Stream assembly from ragged block rows (the v1 path's second kernel):
the port's plain version (the CUDA kernel's twin, bit for bit) vs the JAX
package's Pallas bit writer in interpret mode.  Every case has N = 128
blocks, nb = 64; the JAX side compiles once per capacity."""

import functools

import jax
import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import golden as jgolden
from tinyimgcodec_tpu.constants import ZIGZAG_ORDER
from tinyimgcodec_tpu.ops import transform as jtransform
from tinyimgcodec_tpu.ops.pallas_stitch import stitch_pallas
from tinyimgcodec_tpu_torch.ops import encode1, stitch as tst
from tinyimgcodec_tpu_torch.tables import CodecTables

from conftest import synthetic_image

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
