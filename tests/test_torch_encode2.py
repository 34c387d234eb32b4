"""Fused entropy encode: the port's plain version (the CUDA kernels' twin,
bit for bit on coefficient input) vs the JAX package's Pallas kernel in
interpret mode.  Every case has the shape (64, 128), nb = 64, so the JAX
side compiles once."""

import jax
import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import golden as jgolden
from tinyimgcodec_tpu.constants import ZIGZAG_ORDER
from tinyimgcodec_tpu.ops import transform as jtransform
from tinyimgcodec_tpu.ops.pallas_encode2 import encode_pallas2
from tinyimgcodec_tpu_torch.ops import encode2 as tenc
from tinyimgcodec_tpu_torch.tables import CodecTables

from conftest import synthetic_image

QUALITY = 50
N, NB = 128, 64
TABLES = CodecTables.build(QUALITY, "cpu")

# jitted like the JAX pipeline's own stage: traced and compiled once
_JAX_ENCODE = jax.jit(
    lambda zz: encode_pallas2(
        zz, QUALITY, nb=NB, bt=64, interpret=True, from_zz=True
    )
)


def _both(zz_cm: np.ndarray):
    """zz (64, N) int32 through both packages -> (mine, theirs) as numpy
    (packed uint32 (N, 56), meta uint32 (2, N), overflow bool)."""
    pj, mj, oj = _JAX_ENCODE(zz_cm)
    pt, mt, ot = tenc.encode2(
        torch.from_numpy(zz_cm.copy()), TABLES, NB, from_zz=True
    )
    mine = (pt.numpy().view(np.uint32), mt.numpy().view(np.uint32), bool(ot))
    theirs = (np.asarray(pj), np.asarray(mj), bool(oj))
    return mine, theirs


def _assert_equal(mine, theirs):
    assert mine[0].shape == theirs[0].shape == (N, 56)
    assert np.array_equal(mine[1], theirs[1]), "meta differs"
    assert np.array_equal(mine[0], theirs[0]), "packed rows differ"
    assert mine[2] == theirs[2]


def _natural(quality=QUALITY, noise=False) -> np.ndarray:
    if noise:
        rng = np.random.RandomState(9)
        imgs = rng.randint(0, 256, (2, 64, 64)).astype(np.uint8)
    else:
        imgs = np.stack([synthetic_image(64, 64, seed=s) for s in (41, 42)])
    blocks = np.asarray(jtransform.blockify(imgs)).reshape(-1, 8, 8)
    co = jgolden.quantize(
        jgolden.block_dct(blocks.astype(np.float64) - 128.0), quality
    ).reshape(-1, 64)[:, ZIGZAG_ORDER]
    return np.ascontiguousarray(co.T.astype(np.int32))


def test_natural_content_all_outputs_equal():
    mine, theirs = _both(_natural())
    _assert_equal(mine, theirs)
    assert not mine[2]


def test_dense_noise_all_outputs_equal():
    mine, theirs = _both(_natural(quality=90, noise=True))
    _assert_equal(mine, theirs)


def test_image_boundary_resets_dc_and_aligns_to_a_byte():
    zz = _natural()
    mine, theirs = _both(zz)
    off, bits = mine[1][0].astype(np.int64), mine[1][1].astype(np.int64)
    assert off[0] == 0
    assert off[NB] % 8 == 0
    assert off[NB] == (off[NB - 1] + bits[NB - 1] + 7) // 8 * 8
    # inside an image offsets are the running sum of the counts
    assert np.array_equal(off[1:NB], np.cumsum(bits[: NB - 1]))
    assert np.array_equal(off[NB + 1:] - off[NB], np.cumsum(bits[NB:-1]))
    # DC reset: swapping image 0's content leaves image 1's rows' content
    # (up to its phase, which is 0 at a byte-aligned start) unchanged
    zz2 = zz.copy()
    zz2[:, :NB] = 0
    p2 = tenc.encode2(torch.from_numpy(zz2), TABLES, NB, from_zz=True)[0]
    assert np.array_equal(
        p2.numpy().view(np.uint32)[NB], mine[0][NB]
    )


@pytest.mark.parametrize("gap", [15, 16, 17, 31, 32, 47, 48, 49, 62])
def test_long_zero_runs(gap):
    """Runs >= 16, >= 32, >= 48 take one, two, three ZRL prefixes."""
    rng = np.random.RandomState(gap)
    zz = np.zeros((64, N), np.int32)
    zz[0] = rng.randint(-50, 50, N)
    zz[1 + gap] = rng.randint(1, 1023, N) * rng.choice([-1, 1], N)
    zz[63, ::3] = -1  # a second run after the first, to the last slot
    mine, theirs = _both(zz)
    _assert_equal(mine, theirs)


def test_worst_case_block_fills_the_row():
    """63 AC coefficients of size 10 with 16-bit codes: the longest legal
    block (1662 bits), at every bit phase."""
    rng = np.random.RandomState(3)
    zz = np.zeros((64, N), np.int32)
    zz[0] = np.where(np.arange(N) % 2 == 0, 1500, -1500)
    zz[1:] = rng.randint(512, 1024, (63, N)) * rng.choice([-1, 1], (63, N))
    zz[1:, 1::2] = 0  # short blocks in between move the phase around
    zz[5, 1::2] = rng.randint(1, 8, N // 2)
    mine, theirs = _both(zz)
    _assert_equal(mine, theirs)
    assert mine[1][1].max() >= 1600


@pytest.mark.parametrize(
    "row, value, expect",
    [(0, 2047, False), (0, 2048, True), (0, -2048, True),
     (7, 1023, False), (7, 1024, True), (63, -1024, True)],
)
def test_table_range_overflow_flag(row, value, expect):
    """DC difference of category 12 or an AC coefficient of size 11 lies
    outside the Annex K tables: the flag is raised, as in JAX."""
    zz = _natural()
    if row == 0:
        zz[0, NB:] = 0  # differences: +value, 0, -value
        zz[0, 71] = value
    zz[row, 70] = value
    mine, theirs = _both(zz)
    assert mine[2] == theirs[2] == expect
    if not expect:
        _assert_equal(mine, theirs)


def test_pixel_input_uses_the_fast_transform():
    imgs = np.stack([synthetic_image(64, 64, seed=s) for s in (41, 42)])
    blocks = torch.from_numpy(
        np.array(jtransform.blockify(imgs)).reshape(-1, 64)
    )
    zz = tenc.fast_coefficients(blocks, TABLES)
    a = tenc.encode2(blocks, TABLES, NB)
    b = tenc.encode2(zz, TABLES, NB, from_zz=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    theirs = np.asarray(jtransform.encode_blocks(
        np.asarray(jtransform.blockify(imgs)), QUALITY, jtransform.FAST
    )).reshape(-1, 64)
    diff = np.abs(zz.numpy().T.astype(np.int64) - theirs)
    # the tie bar of the float32 transform (see test_torch_transform.py)
    assert diff.max() <= 1 and (diff != 0).sum() <= 1e-4 * diff.size


def test_wrapper_validates_and_counts_no_launch_on_cpu():
    before = tenc.launches
    tenc.encode2(torch.zeros((64, 8), dtype=torch.int32), TABLES, 4,
                 from_zz=True)
    assert tenc.launches == before
    with pytest.raises(ValueError):
        tenc.encode2(torch.zeros((64, 9), dtype=torch.int32), TABLES, 4,
                     from_zz=True)
    with pytest.raises(ValueError):
        tenc.encode2(torch.zeros((8, 64), dtype=torch.int32), TABLES, 4)
