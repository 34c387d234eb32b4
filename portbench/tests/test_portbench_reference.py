"""The plain reference against the port's float64 host oracle, and the
work counts of the passes.  (The test may import the port; the reference
imports nothing of it.)"""

from __future__ import annotations

import numpy as np
import pytest

from portbench import traffic
from portbench.loader import Bench
from portbench.reference import codec

from tinyimgcodec_tpu_torch import container


def _images(h, w, n, gen, seed):
    cfg = {"height": h, "width": w, "images_per_call": n, "generator": gen}
    return traffic.pool_inputs(cfg, seed, 1)[0]


@pytest.mark.parametrize("h, w, gen", [(64, 64, "synthetic_corpus"),
                                       (37, 53, "seeded_image"),
                                       (8, 200, "seeded_image")])
@pytest.mark.parametrize("quality", [10, 50, 90])
def test_streams_and_pixels_equal_the_oracles(h, w, gen, quality):
    images = _images(h, w, 3, gen, 2**31 + quality)
    streams, coeffs = codec.encode(images, quality)
    pixels = codec.decode_pixels(coeffs, h, w, quality)
    for im, s, px in zip(images, streams, pixels):
        assert s == container.compress(im, quality, block_index=True)
        assert np.array_equal(px, container.decompress(s))


@pytest.mark.parametrize("stride", [1, 16, 256])
def test_other_index_strides_equal_the_oracles(stride):
    images = _images(48, 80, 2, "seeded_image", 5)
    streams, _ = codec.encode(images, 50, index_stride=stride)
    for im, s in zip(images, streams):
        assert s == container.compress(im, 50, block_index=True,
                                       index_stride=stride)


def test_a_corpus_sized_image_equals_the_oracle():
    images = _images(512, 512, 1, "synthetic_corpus", 3)
    streams, coeffs = codec.encode(images, 50)
    assert streams[0] == container.compress(images[0], 50, block_index=True)
    assert np.array_equal(codec.decode_pixels(coeffs, 512, 512, 50)[0],
                          container.decompress(streams[0]))


def test_groups_of_images_give_the_same_streams(monkeypatch):
    images = _images(32, 32, 5, "synthetic_corpus", 9)
    whole, _ = codec.encode(images, 50)
    monkeypatch.setattr(codec, "_GROUP_PIXELS", 2 * 32 * 32)
    assert codec.encode(images, 50)[0] == whole


def test_a_coefficient_beyond_the_table_is_refused():
    zz = np.zeros((1, 64), np.int32)
    zz[0, 5] = 1 << 11  # AC size 12
    with pytest.raises(ValueError):
        codec._tokens(zz)


def test_the_same_seed_gives_the_same_inputs_and_another_seed_others():
    cfg = {"height": 64, "width": 64, "images_per_call": 4,
           "generator": "synthetic_corpus"}
    a = traffic.pool_inputs(cfg, 2**33 + 7, 2)
    b = traffic.pool_inputs(cfg, 2**33 + 7, 2)
    c = traffic.pool_inputs(cfg, 2**33 + 8, 2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])
    assert traffic.pool_inputs(cfg, -5, 1)[0].shape == (4, 64, 64)


def test_the_corpus_work_counts():
    b = Bench()
    cfg = b.config("corpus512-q50-exact")
    enc = b.work("encode_pass")
    assert enc.blocks(cfg) == 200_704
    w = enc.work(cfg, 904_045)
    assert w["flops"] == 411_041_792
    assert w["bytes"] == 12_845_056 + 904_045 + 4 * 49
    assert w["rate"] == "fp64_tensor_flop_s"
    d = b.work("decode_pass").work(cfg, 904_045)
    assert d["flops"] == 411_041_792
    assert d["bytes"] == 12_845_056 + 904_045
    peaks = b.peaks("NVIDIA H100 80GB HBM3")
    assert peaks["fp64_tensor_flop_s"] == 67e12
    assert peaks["hbm_bytes_s"] == 3.35e12
    assert b.work("encode_pass").work(
        dict(cfg, precision="fast"), 0)["rate"] == "fp32_flop_s"
