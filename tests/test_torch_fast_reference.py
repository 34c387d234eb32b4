"""Fast precision's bytes against the benchmark's float32 reference.

The encode kernel's float32 arithmetic (each coefficient summed over
pixels 0..63 in ascending order, one rounding a product and a sum) defines
fast mode's bytes; ``portbench/reference_torch/fast.py`` writes it from the
format's definition without the program.  Here the port's plain path on
the CPU is held to that reference byte for byte, and to the card's corpus
hash, and a transform in a narrower float gives streams the reference
refuses.
"""

import hashlib

import numpy as np
import pytest
import torch

from portbench import compare
from portbench.reference_torch import fast
from tinyimgcodec_tpu_torch import api, tables
from tinyimgcodec_tpu_torch.corpus import synthetic_corpus
from tinyimgcodec_tpu_torch.ops import encode2

from conftest import synthetic_image

# sha256 of the 49-image corpus's fast streams at quality 50 (index at
# stride 64), which the card has written since the port's second slice
FAST_CORPUS_SHA = (
    "dcc29e818283cd09647bd85773969c24cd479dc0d5dba79b43b2469d78a47549")


def _images(n, h, w, seed):
    return np.stack([synthetic_image(h, w, seed=seed + i) for i in range(n)])


def _port(images, quality, stride=64):
    return api.compress_batch(images, quality, precision="fast",
                              index_stride=stride, device="cpu")


def test_the_references_matrix_and_offset_equal_the_programs():
    for quality in range(1, 96):
        m, off = fast.matrix(quality)
        pm, poff = tables.fast_encode_matrix(quality)
        assert m.dtype == torch.float32 and off.dtype == torch.float32
        assert np.array_equal(m.numpy().view(np.uint32),
                              pm.view(np.uint32)), quality
        assert off.numpy().view(np.uint32) == poff[0].view(np.uint32), (
            quality)


@pytest.mark.parametrize("h, w", [(64, 64), (37, 53), (8, 200)])
@pytest.mark.parametrize("quality", [10, 50, 90])
def test_fast_streams_equal_the_reference(h, w, quality):
    images = _images(3, h, w, 100 * quality + h)
    streams, _ = fast.encode(images, quality)
    assert _port(images, quality) == streams


@pytest.mark.parametrize("stride", [16, 64])
def test_other_index_strides_equal_the_reference(stride):
    images = _images(2, 48, 80, 7)
    streams, _ = fast.encode(images, 50, index_stride=stride)
    assert _port(images, 50, stride) == streams


def test_a_corpus_sized_image_and_the_pool_equal_the_reference():
    images = _images(1, 512, 512, 3)
    (streams, _), = fast.encode_pool([images], 50)
    assert _port(images, 50) == streams


def test_the_fast_corpus_keeps_the_cards_hash():
    """The CPU's plain path gives the card's fast corpus bytes."""
    corpus = synthetic_corpus(49, 512)
    h = hashlib.sha256()
    for i in range(0, 49, 7):  # images are self-contained streams
        for s in _port(corpus[i:i + 7], 50):
            h.update(s)
    assert h.hexdigest() == FAST_CORPUS_SHA


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_a_narrower_transform_gives_streams_the_reference_refuses(
        monkeypatch, dtype):
    """The precision below float32: the same ascending sum in ``dtype``."""

    def narrow(pixels, t):
        m = t.encode_matrix.to(dtype)
        x = pixels.to(dtype)
        acc = x[:, :1] * m[0]
        for q in range(1, 64):
            acc = acc + x[:, q:q + 1] * m[q]
        acc[:, 0] = acc[:, 0] - torch.tensor(t.dc_offset, dtype=dtype)
        return torch.round(acc.float()).to(torch.int32).T.contiguous()

    images = _images(3, 64, 64, 11)
    want, _ = fast.encode(images, 50)
    monkeypatch.setattr(encode2, "fast_coefficients_plain", narrow)
    got = _port(images, 50)
    wrong = compare.streams([(0, got, 1)], [want])
    assert wrong["streams_wrong"] == 3 and wrong["calls_wrong"] == 1
