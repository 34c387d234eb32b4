"""Plain tensor transform functions of the port vs the JAX package's."""

import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import golden as jgolden
from tinyimgcodec_tpu.constants import ZIGZAG_ORDER
from tinyimgcodec_tpu.ops import transform as jtransform
from tinyimgcodec_tpu_torch.ops import transform as ttransform
from tinyimgcodec_tpu_torch.tables import CodecTables

from conftest import synthetic_image


def test_blockify_and_unblockify_equal():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (2, 24, 40)).astype(np.uint8)
    mine = ttransform.blockify(torch.from_numpy(x))
    theirs = np.asarray(jtransform.blockify(x))
    assert mine.shape == theirs.shape
    assert np.array_equal(mine.numpy(), theirs)
    back = ttransform.unblockify(mine, 24, 40)
    assert np.array_equal(back.numpy(), x)
    assert np.array_equal(
        np.asarray(jtransform.unblockify(theirs, 24, 40)), back.numpy()
    )


@pytest.mark.parametrize("shape", [(61, 83), (64, 64), (2, 9, 17), (40, 24)])
def test_pad_to_blocks_equal(shape):
    rng = np.random.RandomState(1)
    x = rng.randint(0, 256, shape).astype(np.uint8)
    mine = ttransform.pad_to_blocks(x)
    assert np.array_equal(mine, jtransform.pad_to_blocks(x))
    if x.ndim == 2:
        assert np.array_equal(mine, jgolden.pad_image(x))


def test_fast_encode_blocks_meets_the_tie_bar():
    """float32 and order-dependent: the port sums in the encode kernel's
    ascending order, XLA in its own, so a coefficient may differ by one
    step -- on at most 1e-4 of the coefficients, each within 1e-3 of a
    half-integer before rounding (judged in float64); everything else is
    equal.  64 images, so that 1e-4 of the coefficients is 26 of them and
    not less than one."""
    quality = 50
    n = 64
    imgs = np.stack([synthetic_image(64, 64, seed=s)
                     for s in range(21, 21 + n)])
    blocks = np.array(jtransform.blockify(imgs))  # (n, 64, 8, 8)
    theirs = np.asarray(
        jtransform.encode_blocks(blocks, quality, jtransform.FAST)
    )
    mine = ttransform.encode_blocks(
        torch.from_numpy(blocks), quality, ttransform.FAST
    ).numpy()
    assert mine.shape == theirs.shape and mine.dtype == theirs.dtype
    diff = np.abs(mine.astype(np.int64) - theirs)
    assert diff.max() <= 1
    assert (diff != 0).sum() <= 1e-4 * diff.size
    m, off = jtransform._fast_encode_matrix(quality)
    y = blocks.reshape(n, 64, 64).astype(np.float64) @ m.astype(np.float64)
    y -= off.astype(np.float64)
    tie_dist = np.abs(y - np.floor(y) - 0.5)
    assert np.all(tie_dist[diff != 0] <= 1e-3)


def test_exact_encode_blocks_equals_golden_after_fixup():
    quality = 50
    img = synthetic_image(64, 64, seed=23)
    blocks = ttransform.blockify(torch.from_numpy(img))  # (64, 8, 8)
    zz, flags = ttransform.encode_blocks(
        blocks, quality, ttransform.EXACT, with_flags=True
    )
    gold = jgolden.quantize(
        jgolden.block_dct(blocks.numpy().astype(np.float64) - 128.0), quality
    ).reshape(-1, 64)[:, ZIGZAG_ORDER]
    keep = ~flags.numpy()
    assert np.array_equal(zz.numpy()[keep], gold[keep])
    assert zz.dtype == torch.int32 and flags.dtype == torch.bool


def test_dc_dpcm_equal():
    rng = np.random.RandomState(2)
    zz = rng.randint(-300, 300, (2, 16, 64)).astype(np.int32)
    d1, a1 = ttransform.dc_dpcm(torch.from_numpy(zz))
    d2, a2 = jtransform.dc_dpcm(zz)
    assert np.array_equal(d1.numpy(), np.asarray(d2))
    assert np.array_equal(a1.numpy(), np.asarray(a2))


def test_encode_blocks_takes_tables_from_numpy():
    """The same arrays through both packages: hand the JAX package's
    tables to the port and get the port's own result."""
    from tinyimgcodec_tpu import constants as jc
    from tinyimgcodec_tpu.ops import entropy as jentropy

    q = 75
    m, off = jtransform._fast_encode_matrix(q)
    dc_comb, ac_comb, zp0, zp1, _ = jentropy._symbol_tables()
    t = CodecTables.from_numpy(
        m, off[0], jtransform.dct_basis(), jc.quant_divisors(q),
        dc_comb, ac_comb, zp0, zp1,
    )
    blocks = ttransform.blockify(
        torch.from_numpy(synthetic_image(32, 32, seed=24))
    )
    for prec in (ttransform.FAST, ttransform.EXACT):
        a = ttransform.encode_blocks(blocks, q, prec, tables=t)
        b = ttransform.encode_blocks(blocks, q, prec)
        assert torch.equal(a, b)
