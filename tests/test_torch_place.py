"""Word placement: the port's plain version (the CUDA kernel's twin) vs
the JAX package's ``assemble_cm`` in interpret mode under each of its
three routings (bt=64: the v4 matmul scatter with the v3 masked roll
behind a cond; bt=8: the v2 delta chain)."""

import functools

import jax
import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import container as jcontainer
from tinyimgcodec_tpu.ops.pallas_place import assemble_cm
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
    zz = exact_coefficients(blocks, quality, t)
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
