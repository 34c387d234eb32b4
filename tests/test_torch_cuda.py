"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: skipped where ``torch.cuda.is_available()`` is false (the
kernels have no interpreter; their arithmetic is covered on the CPU by the
plain versions in the other ``test_torch_*`` files).  On a machine with an
NVIDIA card and ``nvcc``:

    python -m pytest tests/test_torch_cuda.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from tinyimgcodec_tpu_torch import compress_batch, container
from tinyimgcodec_tpu_torch.ops import encode2, exact_transform, place
from tinyimgcodec_tpu_torch.ops import transform
from tinyimgcodec_tpu_torch.pipeline import exact_coefficients
from tinyimgcodec_tpu_torch.tables import CodecTables

from conftest import synthetic_image

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels run only there")
    return torch.device("cuda")


def _blocks(imgs, dev):
    return transform.blockify(torch.from_numpy(imgs).to(dev)).reshape(-1, 64)


@pytest.mark.parametrize("quality, noise", [(50, False), (90, True), (10, False)])
def test_kernels_equal_plain_versions(cuda, quality, noise):
    if noise:
        imgs = np.random.RandomState(1).randint(
            0, 256, (3, 40, 72)).astype(np.uint8)
    else:
        imgs = np.stack([synthetic_image(40, 72, seed=s) for s in (1, 2, 3)])
    t = CodecTables.build(quality, cuda)
    blocks = _blocks(imgs, cuda)
    nb = blocks.shape[0] // 3
    before = (exact_transform.launches, encode2.launches, place.launches)
    zk, fk = exact_transform.exact_transform(blocks, t)
    zp, fp = exact_transform.exact_transform_plain(blocks, t)
    assert torch.equal(zk, zp) and torch.equal(fk, fp)
    zz = exact_coefficients(blocks, quality, t)
    a = encode2.encode2(zz, t, nb, from_zz=True)
    b = encode2.encode2_plain(zz, t, nb, from_zz=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for cap in (3 * 40 * 72 * 4 // 32, blocks.shape[0] * 52, 7):
        k = place.place(a[0], a[1], nb, cap)
        p = place.place_plain(a[0], a[1], nb, cap)
        assert all(torch.equal(x, y) for x, y in zip(k, p))
    after = (exact_transform.launches, encode2.launches, place.launches)
    assert after == (before[0] + 2, before[1] + 1, before[2] + 3)


def test_fast_transform_kernel_meets_the_tie_bar(cuda):
    imgs = np.stack([synthetic_image(64, 64, seed=s) for s in (4, 5)])
    t = CodecTables.build(50, cuda)
    blocks = _blocks(imgs, cuda)
    zk = encode2.fast_coefficients(blocks, t)
    zp = encode2.fast_coefficients_plain(blocks, t)
    diff = (zk.long() - zp.long()).abs()
    assert int(diff.max()) <= 1
    assert int((diff != 0).sum()) <= max(1, 1e-4 * diff.numel())
    a = encode2.encode2(blocks, t, 64)
    b = encode2.encode2_plain(zk, t, 64, from_zz=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_one_large_image_scans_many_chunks(cuda):
    """16 384 blocks in one image: the per-image offset scan walks 16
    chunks with a carry, and offsets pass 2**20 bits."""
    img = np.random.RandomState(8).randint(
        0, 256, (1, 1024, 1024)).astype(np.uint8)
    t = CodecTables.build(90, cuda)
    blocks = _blocks(img, cuda)
    zz = exact_coefficients(blocks, 90, t)
    a = encode2.encode2(zz, t, blocks.shape[0], from_zz=True)
    b = encode2.encode2_plain(zz, t, blocks.shape[0], from_zz=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    cap = blocks.shape[0] * 52
    k = place.place(a[0], a[1], blocks.shape[0], cap)
    p = place.place_plain(a[0], a[1], blocks.shape[0], cap)
    assert all(torch.equal(x, y) for x, y in zip(k, p))
    assert int(k[2]) > 1 << 20


def test_batch_on_the_card_equals_the_oracle(cuda):
    imgs = np.stack([synthetic_image(61, 83, seed=s) for s in (6, 7)])
    out = compress_batch(imgs, 50)  # default device: the card
    for i in range(2):
        assert out[i] == container.compress(imgs[i], 50, block_index=True)
