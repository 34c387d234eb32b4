"""The slice as a whole: ``compress_batch_device`` on the CPU (the plain
versions of the three kernels) vs the JAX package's Pallas pipeline in
interpret mode and vs the float64 oracle.

Exact mode has a bit-exact bar.  Fast mode is float32 and order-dependent,
so its bar is: both packages' streams decode through both packages'
decoders and the PSNR agrees within 0.01 dB.

All JAX runs share the padded shape (2, 64, 64) to keep compiles few.
"""

import numpy as np
import pytest

from tinyimgcodec_tpu import container as jcontainer
from tinyimgcodec_tpu.metrics import psnr
from tinyimgcodec_tpu.pallas_pipeline import compress_batch_pallas
from tinyimgcodec_tpu_torch import container as tcontainer
from tinyimgcodec_tpu_torch.pipeline import compress_batch_device

from conftest import synthetic_image

NATURAL = np.stack([synthetic_image(64, 64, seed=s) for s in (61, 62)])
NOISE = np.random.RandomState(17).randint(0, 256, (2, 64, 64)).astype(np.uint8)


def _jax(imgs, quality, precision, **kw):
    return compress_batch_pallas(
        imgs, quality, bt=64, interpret=True, precision=precision,
        block_index=True, **kw
    )


def _port(imgs, quality, precision, **kw):
    return compress_batch_device(
        imgs, quality, precision=precision, block_index=True, device="cpu",
        **kw
    )


def test_exact_batch_bytes_equal_jax_and_oracle():
    mine = _port(NATURAL, 50, "exact")
    theirs = _jax(NATURAL, 50, "exact")
    for i in range(2):
        oracle = jcontainer.compress(NATURAL[i], 50, block_index=True)
        assert mine[i] == theirs[i] == oracle
        assert tcontainer.compress(NATURAL[i], 50, block_index=True) == oracle


def test_exact_odd_shape_bytes_equal_jax_and_oracle():
    """61x59 pads to 64x64 for the kernels; the header keeps 61x59."""
    odd = np.stack([synthetic_image(61, 59, seed=s) for s in (63, 64)])
    mine = _port(odd, 50, "exact")
    theirs = _jax(odd, 50, "exact")
    for i in range(2):
        oracle = jcontainer.compress(odd[i], 50, block_index=True)
        assert mine[i] == theirs[i] == oracle
        assert jcontainer.decompress(mine[i]).shape == (61, 59)


@pytest.mark.parametrize("shape", [(40, 24), (61, 83), (8, 8), (9, 130)])
def test_exact_shapes_the_jax_kernels_do_not_tile(shape):
    """15 blocks (40x24) is a count the JAX package reroutes away from its
    kernels ("not tileable"); the port takes any block count >= 1 and still
    writes the oracle's bytes."""
    img = synthetic_image(*shape, seed=65)
    if shape == (40, 24):
        with pytest.raises(ValueError, match="not tileable"):
            _jax(img[None], 50, "exact")
    for quality in (50, 85):
        mine = _port(img[None], quality, "exact")[0]
        assert mine == jcontainer.compress(img, quality, block_index=True)


def test_exact_without_index_and_with_other_stride():
    plain = compress_batch_device(NATURAL, 50, precision="exact",
                                  device="cpu")
    strided = _port(NATURAL, 50, "exact", index_stride=16)
    for i in range(2):
        assert plain[i] == jcontainer.compress(NATURAL[i], 50)
        assert strided[i] == jcontainer.compress(
            NATURAL[i], 50, block_index=True, index_stride=16
        )


def test_fast_mode_cross_decodes_and_matches_jax_psnr():
    mine = _port(NATURAL, 50, "fast")
    theirs = _jax(NATURAL, 50, "fast")
    for i in range(2):
        decoded = []
        for stream in (mine[i], theirs[i]):
            a = jcontainer.decompress(stream)
            b = tcontainer.decompress(stream)
            assert np.array_equal(a, b)  # both decoders, both streams
            decoded.append(a)
        p_mine = psnr(NATURAL[i], decoded[0])
        p_theirs = psnr(NATURAL[i], decoded[1])
        assert abs(p_mine - p_theirs) <= 0.01


def test_capacity_retry_behaves_as_in_jax():
    """Noise at quality 90 overflows the 4 bpp budget: one retry at
    n * 52 words, then the same bytes as the oracle."""
    mine = _port(NOISE, 90, "exact")
    for i in range(2):
        assert mine[i] == jcontainer.compress(NOISE[i], 90, block_index=True)
        assert len(mine[i]) - 16 > 64 * 64 * 4 // 8  # really over budget
    theirs = _jax(NOISE, 90, "fast")
    fast = _port(NOISE, 90, "fast")
    for i in range(2):
        a = jcontainer.decompress(fast[i])
        b = jcontainer.decompress(theirs[i])
        assert abs(psnr(NOISE[i], a) - psnr(NOISE[i], b)) <= 0.01


def test_table_range_error_behaves_as_in_jax():
    """Black/white 4-pixel bars at quality 99 need an AC size beyond the
    Annex K tables: both pipelines raise the same ValueError, and the
    oracle refuses too."""
    y, x = np.mgrid[0:64, 0:64]
    board = ((x % 8 >= 4) * 255).astype(np.uint8)
    imgs = np.stack([board, board])
    with pytest.raises(ValueError, match="out of Huffman table range"):
        _port(imgs, 99, "fast")
    with pytest.raises(ValueError, match="out of Huffman table range"):
        _port(imgs, 99, "exact")
    with pytest.raises(ValueError, match="out of Huffman table range"):
        _jax(imgs, 99, "fast")
    with pytest.raises(ValueError):
        jcontainer.compress(board, 99)


def _contents(h, w):
    y, x = np.mgrid[0:h, 0:w]
    return {
        "noise": np.random.RandomState(19).randint(0, 256, (h, w)),
        "checker1": (x + y) % 2 * 255,
        "checker4": ((x // 4 + y // 4) % 2) * 255,
        "hgrad": x * 255 // max(w - 1, 1),
        "flat0": np.zeros((h, w)),
        "flat255": np.full((h, w), 255),
        "stripes": (x % 2) * 255,
    }


@pytest.mark.parametrize("quality", [1, 50, 90, 96])
def test_exact_adversarial_content_equals_oracle_or_refuses(quality):
    """Flat, noise, checker and stripe content in one odd-shaped batch:
    byte-equal to the oracle where the oracle encodes, the documented
    error where it refuses (content outside the Annex K tables)."""
    imgs = np.stack(
        [c.astype(np.uint8) for c in _contents(40, 56).values()]
    )
    try:
        refs = [jcontainer.compress(im, quality, block_index=True)
                for im in imgs]
    except ValueError:
        with pytest.raises(ValueError, match="Huffman table range"):
            _port(imgs, quality, "exact")
        return
    assert _port(imgs, quality, "exact") == refs
    fast = _port(imgs, quality, "fast")
    for im, stream in zip(imgs, fast):
        assert jcontainer.decompress(stream).shape == im.shape


def test_true_shape_and_tensor_input():
    import torch

    from tinyimgcodec_tpu_torch.ops.transform import pad_to_blocks

    odd = synthetic_image(61, 59, seed=66)
    padded = torch.from_numpy(pad_to_blocks(odd)[None].copy())
    out = compress_batch_device(
        padded, 50, precision="exact", block_index=True,
        true_shape=(61, 59), device="cpu",
    )[0]
    assert out == jcontainer.compress(odd, 50, block_index=True)
    with pytest.raises(ValueError, match="block-aligned"):
        compress_batch_device(torch.from_numpy(odd[None].copy()), 50,
                              device="cpu")


@pytest.mark.parametrize("entry", ["compress", "compress auto table",
                                   "compress_batch"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_an_image_over_the_pixel_limit_is_encoded_in_block_ranges(
        precision, entry, monkeypatch):
    """With the limit lowered to 37 blocks, a 100x123 image (208 blocks)
    goes through ``pipeline.compress_image`` in six calls of the kernels with the DC
    predictor carried across each cut: exact mode gives the oracle's
    bytes, fast mode the bytes of the uncut call, trailer included."""
    from tinyimgcodec_tpu_torch import api, pipeline

    img = synthetic_image(100, 123, seed=76)
    auto = entry == "compress auto table"

    def run():
        if entry == "compress_batch":
            return api.compress_batch(np.stack([img, img]), 50,
                                      precision=precision, device="cpu")
        return [api.compress(img, 50, auto_generate_huffman_table=auto,
                             precision=precision, device="cpu")]

    uncut = run()
    monkeypatch.setattr(pipeline, "MAX_PIXELS", 64 * 37)
    calls = []
    real = pipeline.encode2

    def spy(x, tables, nb, from_zz=False, dc_init=None):
        calls.append(nb)
        return real(x, tables, nb, from_zz=from_zz, dc_init=dc_init)

    monkeypatch.setattr(pipeline, "encode2", spy)
    got = run()
    assert got == uncut
    assert calls == ([37] * 5 + [23]) * len(got)
    if precision == "exact":
        oracle = jcontainer.compress(img, 50, auto, block_index=True)
        assert got == [oracle] * len(got)
    for data in got:
        assert np.array_equal(tcontainer.decompress(data),
                              jcontainer.decompress(data))


def test_a_mixed_batch_with_an_oversize_image(monkeypatch):
    """A list of one image over the (lowered) limit and two under it: the
    large one is cut into block ranges, the others form one batch; each
    stream is the oracle's."""
    from tinyimgcodec_tpu_torch import api, pipeline

    imgs = [synthetic_image(72, 72, seed=77), synthetic_image(40, 48, seed=78),
            synthetic_image(40, 48, seed=79)]
    monkeypatch.setattr(pipeline, "MAX_PIXELS", 40 * 48 * 5 // 2)
    got = api.compress_batch(imgs, 50, device="cpu")
    assert got == [jcontainer.compress(im, 50, block_index=True)
                   for im in imgs]


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_a_batch_over_the_pixel_limit_is_cut_at_image_boundaries(
        precision, as_tensor, monkeypatch):
    """Images are self-contained streams, so a batch of more pixels than
    the limit goes through in calls of whole images under it and gives
    the bytes of one call.  (The limit is lowered to 2.5 images here.)"""
    import torch

    from tinyimgcodec_tpu_torch import pipeline

    imgs = np.stack([synthetic_image(40, 48, seed=s) for s in range(70, 75)])
    whole = compress_batch_device(imgs, 50, precision=precision,
                                  block_index=True, device="cpu")
    monkeypatch.setattr(pipeline, "MAX_PIXELS", 40 * 48 * 5 // 2)
    batch = torch.from_numpy(imgs.copy()) if as_tensor else imgs
    blocks = []  # the blocks of each encode2 call
    real = pipeline.encode2

    def spy(x, tables, nb, from_zz=False, dc_init=None):
        blocks.append(x.shape[1] if from_zz else x.shape[0])
        return real(x, tables, nb, from_zz=from_zz, dc_init=dc_init)

    monkeypatch.setattr(pipeline, "encode2", spy)
    got = compress_batch_device(batch, 50, precision=precision,
                                block_index=True, device="cpu")
    assert got == whole
    assert blocks == [2 * 30, 2 * 30, 30]
    if precision == "exact":
        assert got == [jcontainer.compress(im, 50, block_index=True)
                       for im in imgs]
    # an image over the limit alone: block ranges on the v2 kernels; the
    # v1 kernels cannot cut it
    big = synthetic_image(72, 72, seed=75)
    assert compress_batch_device(big[None], 50, precision="exact",
                                 block_index=True, device="cpu") == [
        jcontainer.compress(big, 50, block_index=True)]
    with pytest.raises(NotImplementedError, match="v1"):
        compress_batch_device(big[None], 50, precision="fast", device="cpu",
                              version="v1")


@pytest.mark.parametrize(
    "imgs, quality",
    [(NATURAL, 50), (NATURAL, 10), (NOISE, 90),
     (np.stack([synthetic_image(61, 59, seed=s) for s in (67, 68, 69)]), 75)],
)
def test_v1_bytes_equal_v2_fast_bytes(imgs, quality):
    """The v1 path (encode1 + stitch) and the v2 path (encode2 + place)
    write the same fast-mode bytes -- also through the capacity retry
    (noise at quality 90 overflows the 4 bpp budget)."""
    v2 = compress_batch_device(imgs, quality, precision="fast", device="cpu")
    v1 = compress_batch_device(imgs, quality, precision="fast", device="cpu",
                               version="v1")
    assert v1 == v2
    for im, s in zip(imgs, v1):
        assert tcontainer.decompress(s).shape == im.shape


def test_v1_cross_decodes_and_matches_jax_v1_psnr():
    mine = compress_batch_device(NATURAL, 50, precision="fast", device="cpu",
                                 version="v1")
    theirs = compress_batch_pallas(NATURAL, 50, bt=64, interpret=True,
                                   precision="fast", version="v1")
    for i in range(2):
        a = jcontainer.decompress(mine[i])
        b = jcontainer.decompress(theirs[i])
        assert abs(psnr(NATURAL[i], a) - psnr(NATURAL[i], b)) <= 0.01


def test_exact_mode_ignores_version_as_in_jax():
    a = compress_batch_device(NATURAL, 50, precision="exact", device="cpu",
                              version="v1")
    assert a == [jcontainer.compress(im, 50) for im in NATURAL]


def test_v1_refuses_the_block_index_and_unknown_versions():
    with pytest.raises(ValueError, match="block_index requires the v2"):
        compress_batch_device(NATURAL, 50, precision="fast", device="cpu",
                              version="v1", block_index=True)
    with pytest.raises(ValueError, match="block_index requires the v2"):
        compress_batch_pallas(NATURAL, 50, bt=64, interpret=True,
                              version="v1", block_index=True)
    with pytest.raises(ValueError, match="unknown version"):
        compress_batch_device(NATURAL, 50, device="cpu", version="v3")


def test_v1_table_range_error():
    y, x = np.mgrid[0:64, 0:64]
    board = ((x % 8 >= 4) * 255).astype(np.uint8)
    with pytest.raises(ValueError, match="out of Huffman table range"):
        compress_batch_device(np.stack([board, board]), 99, precision="fast",
                              device="cpu", version="v1")
