"""Block-local entropy encode (the v1 path's first kernel): the port's
plain version (the CUDA kernel's twin, bit for bit on coefficient input)
vs the JAX package's Pallas kernel in interpret mode.  Most cases have the
shape (128, 64), nb = 64, so the JAX side compiles once per input form; the
ragged shapes (block counts that are no multiple of the CUDA kernel's tile
of 128, images of 1 and of 45 blocks) compile once each."""

import functools

import jax
import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import golden as jgolden
from tinyimgcodec_tpu.constants import ZIGZAG_ORDER
from tinyimgcodec_tpu.ops import transform as jtransform
from tinyimgcodec_tpu.ops.pallas_encode import encode_pallas
from tinyimgcodec_tpu_torch.ops import encode1 as tenc
from tinyimgcodec_tpu_torch.ops import encode2 as tenc2
from tinyimgcodec_tpu_torch.tables import CodecTables

from conftest import synthetic_image

N, NB = 128, 64
TABLES = {q: CodecTables.build(q, "cpu") for q in (50, 90)}


# jitted like the JAX pipeline's own stage: traced and compiled once a shape
@functools.cache
def _jax_from_zz(n, nb):
    bt = 64 if n % 64 == 0 else n  # one tile where 64 does not divide n
    return jax.jit(
        lambda zz: encode_pallas(zz, 50, nb=nb, bt=bt, interpret=True,
                                 from_zz=True)
    )


_JAX_PIXELS = {
    q: jax.jit(lambda x, q=q: encode_pallas(x, q, nb=NB, bt=64,
                                            interpret=True))
    for q in (50, 90)
}


def _images(noise=False):
    if noise:
        return np.random.RandomState(9).randint(
            0, 256, (2, 64, 64)).astype(np.uint8)
    return np.stack([synthetic_image(64, 64, seed=s) for s in (41, 42)])


def _coefficients(quality=50, noise=False) -> np.ndarray:
    """(N, 64) int32 block-major float64-oracle coefficients."""
    blocks = np.asarray(jtransform.blockify(_images(noise))).reshape(-1, 8, 8)
    co = jgolden.quantize(
        jgolden.block_dct(blocks.astype(np.float64) - 128.0), quality
    ).reshape(-1, 64)[:, ZIGZAG_ORDER]
    return np.ascontiguousarray(co.astype(np.int32))


def _both(zz: np.ndarray, quality=50, nb=NB):
    # the tables do not depend on quality
    wj, bj, oj = _jax_from_zz(zz.shape[0], nb)(zz)
    wt, bt, ot = tenc.encode1(torch.from_numpy(zz.copy()), TABLES[quality],
                              nb, from_zz=True)
    mine = (wt.numpy().view(np.uint32), bt.numpy(), bool(ot))
    theirs = (np.asarray(wj), np.asarray(bj), bool(oj))
    return mine, theirs


def _assert_equal(mine, theirs, n=N):
    assert mine[0].shape == theirs[0].shape == (n, 52)
    assert np.array_equal(mine[1], theirs[1]), "bit counts differ"
    assert np.array_equal(mine[0], theirs[0]), "words differ"
    assert mine[2] == theirs[2]


# (n, nb): the seed shape, then block counts around the CUDA kernel's tile
# of 128 and images of 1 and 45 blocks (several predictor resets a tile)
SHAPES = [(128, 64), (1, 1), (127, 127), (127, 1), (129, 43), (300, 300),
          (300, 1), (135, 45)]


@pytest.mark.parametrize("n, nb", SHAPES,
                         ids=[f"N{n}-nb{nb}" for n, nb in SHAPES])
@pytest.mark.parametrize("quality, noise", [(50, False), (90, True)])
def test_coefficient_input_all_outputs_equal(quality, noise, n, nb):
    zz = np.resize(_coefficients(quality, noise), (n, 64))
    mine, theirs = _both(zz, quality, nb)
    _assert_equal(mine, theirs, n)
    assert not mine[2]


def test_rows_start_at_bit_zero_and_are_zero_after_their_bits():
    mine, _ = _both(_coefficients())
    words, bits = mine[0], mine[1].astype(np.int64)
    as_bits = np.unpackbits(
        words.astype(">u4").view(np.uint8).reshape(N, -1), axis=1)
    for b in (0, 1, 63, 64, 127):
        assert not as_bits[b, bits[b]:].any()
        # every block opens with a DC code and ends with EOB "1010"
        assert as_bits[b, bits[b] - 4: bits[b]].tolist() == [1, 0, 1, 0]


def test_image_boundary_resets_the_dc_predictor():
    zz = _coefficients()
    mine, theirs = _both(zz)
    _assert_equal(mine, theirs)
    zz2 = zz.copy()
    zz2[:NB] = 0  # another first image leaves the second one's rows alone
    other, _ = _both(zz2)
    assert np.array_equal(other[0][NB:], mine[0][NB:])
    assert np.array_equal(other[1][NB:], mine[1][NB:])
    zz3 = zz.copy()
    zz3[NB - 1, 0] += 5  # inside an image the neighbour's DC matters
    zz3[NB - 2, 0] += 5
    third, _ = _both(zz3)
    assert not np.array_equal(third[0][NB - 2], mine[0][NB - 2])
    assert np.array_equal(third[0][NB], mine[0][NB])


@pytest.mark.parametrize("gap", [15, 16, 31, 32, 47, 48, 62])
def test_long_zero_runs(gap):
    rng = np.random.RandomState(gap)
    zz = np.zeros((N, 64), np.int32)
    zz[:, 0] = rng.randint(-50, 50, N)
    zz[:, 1 + gap] = rng.randint(1, 1023, N) * rng.choice([-1, 1], N)
    zz[::3, 63] = -1
    _assert_equal(*_both(zz))


@pytest.mark.parametrize("n, nb", [(128, 64), (129, 43), (135, 45)])
def test_worst_case_block_fills_the_row(n, nb):
    """63 AC coefficients of size 10 with 16-bit codes: 1662 bits, all 52
    words of the row; every other block is the shortest one, 6 bits."""
    rng = np.random.RandomState(3)
    zz = np.zeros((n, 64), np.int32)
    zz[:, 0] = np.where(np.arange(n) % 4 == 0, 1500, -1500)
    zz[:, 1:] = rng.randint(512, 1024, (n, 63)) * rng.choice([-1, 1], (n, 63))
    zz[1::2] = 0
    zz[1::2, 0] = zz[0::2, 0][: n // 2]  # DC difference 0, no AC: 6 bits
    mine, theirs = _both(zz, nb=nb)
    _assert_equal(mine, theirs, n)
    assert mine[1].max() >= 1600 and mine[0][:, 51].any()
    assert mine[1].min() == 6


@pytest.mark.parametrize(
    "col, value, expect",
    [(0, 2047, False), (0, 2048, True), (7, 1023, False), (7, 1024, True),
     (63, -1024, True)],
)
def test_table_range_overflow_flag(col, value, expect):
    zz = _coefficients()
    if col == 0:
        zz[NB:, 0] = 0
        zz[71, 0] = value
    zz[70, col] = value
    mine, theirs = _both(zz)
    assert mine[2] == theirs[2] == expect
    if not expect:
        _assert_equal(mine, theirs)


@pytest.mark.parametrize("quality, noise", [(50, False), (90, True)])
def test_pixel_input_meets_the_tie_bar(quality, noise):
    """Pixel input runs the float32 transform, which is order-dependent:
    coefficients at most one step apart, and only where the value before
    rounding lies within 1e-3 of a tie; where the coefficients agree the
    words are equal."""
    imgs = _images(noise)
    blocks = np.array(jtransform.blockify(imgs)).reshape(-1, 64)
    t = TABLES[quality]
    mine = tenc.encode1(torch.from_numpy(blocks), t, NB)
    zz_mine = tenc2.fast_coefficients(torch.from_numpy(blocks), t).T
    again = tenc.encode1(zz_mine.contiguous(), t, NB, from_zz=True)
    for a, b in zip(mine, again):
        assert torch.equal(a, b)
    wj, bj, oj = _JAX_PIXELS[quality](blocks)
    zz_jax = np.asarray(jtransform.encode_blocks(
        np.asarray(jtransform.blockify(imgs)), quality, jtransform.FAST
    )).reshape(-1, 64)
    diff = np.abs(zz_mine.numpy().astype(np.int64) - zz_jax)
    y = blocks.astype(np.float64) @ t.encode_matrix.numpy().astype(np.float64)
    y[:, 0] -= t.dc_offset
    frac = np.abs(y - np.floor(y) - 0.5)
    assert diff.max() <= 1 and not ((diff != 0) & (frac > 1e-3)).any()
    same = (diff == 0).all(axis=1)
    same[1:] &= same[:-1].copy()  # the DC code also needs the neighbour's
    assert same.sum() >= N - 4
    assert np.array_equal(mine[0].numpy().view(np.uint32)[same],
                          np.asarray(wj)[same])
    assert np.array_equal(mine[1].numpy()[same], np.asarray(bj)[same])
    assert bool(mine[2]) == bool(oj)


def test_wrapper_validates_and_counts_no_launch_on_cpu():
    before = tenc.launches
    tenc.encode1(torch.zeros((8, 64), dtype=torch.int32), TABLES[50], 4,
                 from_zz=True)
    assert tenc.launches == before
    with pytest.raises(ValueError):
        tenc.encode1(torch.zeros((9, 64), dtype=torch.int32), TABLES[50], 4,
                     from_zz=True)
    with pytest.raises(ValueError):
        tenc.encode1(torch.zeros((64, 8), dtype=torch.uint8), TABLES[50], 4)
    with pytest.raises(ValueError):
        tenc.encode1(torch.zeros((8, 64), dtype=torch.uint8), TABLES[50], 4,
                     from_zz=True)
