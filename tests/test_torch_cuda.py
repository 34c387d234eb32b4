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

from tinyimgcodec_tpu_torch import (
    compress_batch, container, decompress, decompress_batch, golden,
    profiling,
)
from tinyimgcodec_tpu_torch.constants import ZIGZAG_ORDER
from tinyimgcodec_tpu_torch.corpus import (
    blocks_of_random_bits, synthetic_corpus,
)
from tinyimgcodec_tpu_torch.engine import Engine
from tinyimgcodec_tpu_torch.ops import (
    _build, encode1, encode2, entropy_decode, exact_inverse, exact_transform,
    place, stitch, symbol_stats,
)
from tinyimgcodec_tpu_torch.ops import transform
from tinyimgcodec_tpu_torch.pipeline import (
    compress_batch_device, exact_coefficients,
)
from tinyimgcodec_tpu_torch.tables import (
    CodecTables, DecodeTables, dequant_steps, fast_decode_matrix,
)

from conftest import synthetic_image

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels run only there")
    return torch.device("cuda")


def _blocks(imgs, dev):
    return transform.blockify(torch.from_numpy(imgs).to(dev)).reshape(-1, 64)


def _oracle(blocks, quality):
    """The float64 oracle's (N, 64) zig-zag coefficients of ``blocks``
    (``golden``: scipy's DCT, division by the divisors, half to even)."""
    x = blocks.cpu().numpy().reshape(-1, 8, 8).astype(np.float64) - 128.0
    q = golden.quantize(golden.block_dct(x), quality)
    return torch.from_numpy(q.reshape(-1, 64)[:, ZIGZAG_ORDER].copy())


def _exact_both(blocks, t, quality):
    """The tensor-core transform against the plain version: coefficients
    equal to the float64 oracle's on every block, flagged or not (each
    side settles its flagged blocks in the oracle's arithmetic), flags
    that differ in at most 0.01 % of the blocks (a product summed in
    another order moves a quotient by about 1e-12, against the 1e-9 tie
    window), and each count equal to its flags'.  Returns the kernel's
    flags."""
    zk, fk, nk = exact_transform.exact_transform(blocks, t)
    zp, fp, np_ = exact_transform.exact_transform_plain(blocks, t)
    assert zk.shape == zp.shape and fk.shape == fp.shape
    assert nk.shape == () and nk.dtype == torch.int64
    assert int(nk) == int((fk != 0).sum())
    assert int(np_) == int((fp != 0).sum())
    assert int((fk != fp).sum()) <= blocks.shape[0] // 10000
    gold = _oracle(blocks, quality)
    assert torch.equal(zk.T.cpu(), gold)
    assert torch.equal(zp.T.cpu(), gold)
    assert torch.equal(exact_coefficients(blocks, t).T.cpu(), gold)
    return fk


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
    _exact_both(blocks, t, quality)
    zz = exact_coefficients(blocks, t)
    a = encode2.encode2(zz, t, nb, from_zz=True)
    b = encode2.encode2_plain(zz, t, nb, from_zz=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for cap in (3 * 40 * 72 * 4 // 32, blocks.shape[0] * 52, 7):
        k = place.place(a[0], a[1], nb, cap)
        p = place.place_plain(a[0], a[1], nb, cap)
        assert all(torch.equal(x, y) for x, y in zip(k, p))
    after = (exact_transform.launches, encode2.launches, place.launches)
    assert after == (before[0] + 3, before[1] + 1, before[2] + 3)


def test_fast_transform_kernel_meets_the_tie_bar(cuda):
    """The kernel's float32 transform is fast mode's definition: the plain
    version, on the card and on the CPU, gives its coefficients bit for
    bit, and the pixel-input entropy kernel the plain words."""
    imgs = np.stack([synthetic_image(64, 64, seed=s) for s in (4, 5)])
    t = CodecTables.build(50, cuda)
    blocks = _blocks(imgs, cuda)
    zk = encode2.fast_coefficients(blocks, t)
    assert torch.equal(zk, encode2.fast_coefficients_plain(blocks, t))
    assert torch.equal(zk.cpu(), encode2.fast_coefficients_plain(
        blocks.cpu(), CodecTables.build(50, "cpu")))
    a = encode2.encode2(blocks, t, 64)
    b = encode2.encode2_plain(zk, t, 64, from_zz=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = encode2.encode2_plain(blocks, t, 64)
    assert all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_fast_transform_kernel_equals_the_plain_version_on_random_blocks(
        cuda, quality):
    """200 000 blocks of random pixels, a tenth of them flat but for one
    pixel (many sums near a tie), against the plain version on the CPU."""
    rng = np.random.default_rng(20_000 + quality)
    px = rng.integers(0, 256, (200_000, 64), dtype=np.uint8)
    px[::10] = rng.integers(0, 256, (20_000, 1), dtype=np.uint8)
    px[::10, 0] = rng.integers(0, 256, 20_000, dtype=np.uint8)
    blocks = torch.from_numpy(px)
    zk = encode2.fast_coefficients(blocks.to(cuda),
                                   CodecTables.build(quality, cuda))
    zp = encode2.fast_coefficients_plain(blocks,
                                         CodecTables.build(quality, "cpu"))
    assert torch.equal(zk.cpu(), zp)


def test_one_large_image_scans_many_chunks(cuda):
    """16 384 blocks in one image: the per-image offset scan walks 16
    chunks with a carry, and offsets pass 2**20 bits."""
    img = np.random.RandomState(8).randint(
        0, 256, (1, 1024, 1024)).astype(np.uint8)
    t = CodecTables.build(90, cuda)
    blocks = _blocks(img, cuda)
    zz = exact_coefficients(blocks, t)
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


@pytest.mark.parametrize("quality, noise", [(50, False), (90, True)])
def test_encode1_and_stitch_equal_plain_versions(cuda, quality, noise):
    if noise:
        imgs = np.random.RandomState(2).randint(
            0, 256, (3, 40, 72)).astype(np.uint8)
    else:
        imgs = np.stack([synthetic_image(40, 72, seed=s) for s in (1, 2, 3)])
    t = CodecTables.build(quality, cuda)
    blocks = _blocks(imgs, cuda)
    n = blocks.shape[0]
    nb = n // 3
    before = (encode1.launches, stitch.launches)
    zz = exact_coefficients(blocks, t).T.contiguous()  # (N, 64)
    a = encode1.encode1(zz, t, nb, from_zz=True)
    b = encode1.encode1_plain(zz, t, nb, from_zz=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # pixel input: the plain entropy coding of the kernel's own coefficients
    zk = encode2.fast_coefficients(blocks, t).T.contiguous()
    c = encode1.encode1(blocks, t, nb)
    d = encode1.encode1_plain(zk, t, nb, from_zz=True)
    assert all(torch.equal(x, y) for x, y in zip(c, d))
    total = int(stitch.stitch_plain(a[0], a[1], nb, n * 52)[2])
    exact = -(-total // 32)
    for cap in (n * 52, exact, exact - 1, 7):
        k = stitch.stitch(a[0], a[1], nb, cap)
        p = stitch.stitch_plain(a[0], a[1], nb, cap)
        assert all(torch.equal(x, y) for x, y in zip(k, p))
        assert int(k[3]) == (2 if cap < exact else 0)
    after = (encode1.launches, stitch.launches)
    assert after == (before[0] + 2, before[1] + 4)


def test_stitch_capacity_of_2_to_the_31_bits_is_no_overflow(cuda):
    imgs = np.stack([synthetic_image(40, 72, seed=s) for s in (1, 2)])
    t = CodecTables.build(50, cuda)
    blocks = _blocks(imgs, cuda)
    n = blocks.shape[0]
    words, bits, _ = encode1.encode1(blocks, t, n // 2)
    small = stitch.stitch(words, bits, n // 2, n * 52)
    big = stitch.stitch(words, bits, n // 2, 1 << 26)  # 2**31 bits
    assert int(big[3]) == 0 and int(small[3]) == 0
    assert int(big[2]) == int(small[2])
    assert torch.equal(big[0][: n * 52], small[0])
    assert not bool(big[0][n * 52:].any())


def test_v1_bytes_equal_v2_bytes_on_the_card(cuda):
    imgs = np.stack([synthetic_image(61, 83, seed=s) for s in (6, 7, 8)])
    v2 = compress_batch_device(imgs, 50, precision="fast")
    v1 = compress_batch_device(imgs, 50, precision="fast", version="v1")
    assert v1 == v2


def _decode_both(streams, cuda, quality=50):
    prep = entropy_decode.prepare_batch(streams)
    if prep is None:  # the stream's own bookkeeping refused the batch
        return None
    keys = ("chunk_start", "chunk_blocks", "chunk_block_base",
            "chunk_end_lo", "chunk_end_hi")
    t = DecodeTables.build(quality, False, cuda, huffman=prep["tables"])
    args = [torch.from_numpy(prep["words"].view(np.int32)).to(cuda)] + [
        torch.from_numpy(prep[k]).to(cuda) for k in keys]
    k = entropy_decode.entropy_decode_chunks(*args, prep["nb_total"], t)
    p = entropy_decode.entropy_decode_chunks_plain(*args, prep["nb_total"], t)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    return k[1].cpu().numpy()


@pytest.mark.parametrize("quality, stride, auto",
                         [(50, 64, False), (90, 8, False), (50, 16, True)])
def test_entropy_decode_equals_plain_version(cuda, quality, stride, auto):
    imgs = [synthetic_image(61, 83, seed=s) for s in (3, 3 if auto else 4)]
    streams = [container.compress(im, quality, auto, block_index=True,
                                  index_stride=stride) for im in imgs]
    before = entropy_decode.launches
    assert _decode_both(streams, cuda, quality).all()
    assert entropy_decode.launches == before + 1
    # corrupt: flipped bytes, and a payload cut short under its trailer
    failed = 0
    start = container.parse_block_index(streams[0], 88)[2]
    for pos in range(start - 400, start, 37):
        mut = bytearray(streams[0])
        mut[pos] ^= 0xFF
        ok = _decode_both([bytes(mut), streams[1]], cuda, quality)
        failed += ok is not None and not ok.all()
    assert failed
    cut = streams[0][: start - 16] + streams[0][start:]
    ok = _decode_both([cut, streams[1]], cuda, quality)
    assert ok is None or not ok.all()


def test_decode_on_the_card_equals_the_oracle(cuda):
    imgs = [synthetic_image(61, 83, seed=s) for s in (6, 7, 8)]
    streams = [container.compress(im, 50, block_index=True) for im in imgs]
    out = decompress_batch(streams)  # default device: the card
    for o, s in zip(out, streams):
        assert np.array_equal(o, container.decompress(s))
    mut = bytearray(streams[1])
    mut[40] ^= 0xFF
    plain = container.compress(imgs[0], 50)
    eng = Engine("exact")
    for batch in ([streams[0], bytes(mut)], [plain, streams[2]]):
        got = eng.decompress_batch(batch)
        assert sum(eng.decode_stats.values()) == 2
        for o, s in zip(got, batch):
            assert np.array_equal(o, container.decompress(s))
    assert np.array_equal(decompress(plain), container.decompress(plain))


# ---- the shapes that steer encode2's copy paths and its scan ---------------


def _encode2_both(zz, t, nb):
    a = encode2.encode2(zz, t, nb, from_zz=True)
    b = encode2.encode2_plain(zz, t, nb, from_zz=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    return a


@pytest.mark.parametrize(
    "shape, quality",
    [((3, 40, 72), 90),      # N = 135: no multiple of 4, nb below a tile
     ((3, 136, 152), 90),    # nb = 323: odd, ragged third tile
     ((3, 120, 160), 50),    # nb = 300: ragged, rows on 16 bytes
     ((4096, 8, 8), 75),     # every tile starts an image
     ((1, 1024, 2048), 50)], # 256 tiles in one look-back chain
    ids=["N135", "nb323", "nb300", "one-block-images", "one-image"],
)
def test_encode2_shapes_equal_plain_version(cuda, shape, quality):
    imgs = np.random.RandomState(5).randint(0, 256, shape).astype(np.uint8)
    t = CodecTables.build(quality, cuda)
    blocks = _blocks(imgs, cuda).contiguous()
    nb = blocks.shape[0] // shape[0]
    zz, _, _ = exact_transform.exact_transform(blocks, t)
    first = _encode2_both(zz, t, nb)
    # one word off 16-byte alignment: the 4-byte copy path, same words
    buf = torch.empty(zz.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = buf[1:].view(zz.shape)
    shifted.copy_(zz)
    assert shifted.data_ptr() % 16
    _encode2_both(shifted, t, nb)
    # pixel form: the plain coding of the transform kernel's coefficients
    zk = encode2.fast_coefficients(blocks, t)
    a = encode2.encode2(blocks, t, nb)
    b = encode2.encode2_plain(zk, t, nb, from_zz=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the scan's state is reset by every call
    for _ in range(5):
        again = encode2.encode2(zz, t, nb, from_zz=True)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])


def test_encode2_longest_block_and_overflow_flags(cuda):
    rng = np.random.RandomState(3)
    t = CodecTables.build(50, cuda)
    n = 512
    zz = np.zeros((64, n), np.int32)
    zz[0] = np.where(np.arange(n) % 2 == 0, 1000, -1000)
    zz[1:] = rng.randint(512, 1024, (63, n)) * rng.choice([-1, 1], (63, n))
    zz[1:, 1::2] = 0
    zz[5, 1::2] = rng.randint(1, 8, n // 2)
    _, meta, over = _encode2_both(torch.from_numpy(zz).to(cuda), t, 64)
    assert int(meta[1].max()) == 1662 and not bool(over)
    for row, value in ((0, 2048), (7, 1024), (63, -1024)):
        flagged = np.zeros((64, n), np.int32)
        flagged[row, 70] = value
        assert bool(_encode2_both(torch.from_numpy(flagged).to(cuda), t,
                                  64)[2])


# ---- the shapes that steer entropy_decode's paths ---------------------------


def _prep_args(streams, cuda):
    prep = entropy_decode.prepare_batch(streams)
    keys = ("chunk_start", "chunk_blocks", "chunk_block_base",
            "chunk_end_lo", "chunk_end_hi")
    t = DecodeTables.build(prep["shape"][2], False, cuda,
                           huffman=prep["tables"])
    args = [torch.from_numpy(prep["words"].view(np.int32)).to(cuda)] + [
        torch.from_numpy(prep[k]).to(cuda) for k in keys]
    return prep, args, t


def _decode_both_arrays(args, nb_total, t):
    k = entropy_decode.entropy_decode_chunks(*args, nb_total, t)
    p = entropy_decode.entropy_decode_chunks_plain(*args, nb_total, t)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    return k[1].cpu().numpy()


@pytest.mark.parametrize(
    "case", ["uneven-density", "one-chunk-an-image", "one-block-images"])
def test_entropy_decode_stream_shapes_equal_plain_version(cuda, case):
    rng = np.random.RandomState(96)
    if case == "uneven-density":
        # flat images and one of noise: its chunks reach past the window
        imgs = np.empty((8, 256, 256), np.uint8)
        imgs[:] = (40 + 25 * np.arange(8)).reshape(8, 1, 1)
        imgs[5] = rng.randint(0, 256, (256, 256))
        streams = compress_batch(imgs, 96, precision="fast", index_stride=16)
    elif case == "one-chunk-an-image":
        imgs = np.stack([synthetic_image(96, 96, seed=s) for s in (1, 2, 3)])
        streams = compress_batch(imgs, 50, index_stride=4096)
    else:
        imgs = rng.randint(0, 256, (2048, 8, 8)).astype(np.uint8)
        streams = compress_batch(imgs, 50)
    prep, args, t = _prep_args(streams, cuda)
    assert _decode_both_arrays(args, prep["nb_total"], t).all()


def test_entropy_decode_launch_shapes_and_window_sizes(cuda):
    """Any launch shape and any window, none included, give the plain
    version's result: where a word comes from is chosen by its address."""
    imgs = np.stack([synthetic_image(128, 128, seed=s) for s in (1, 2, 3)])
    prep, args, t = _prep_args(compress_batch(imgs, 50, index_stride=16),
                               cuda)
    zp, ok_p = entropy_decode.entropy_decode_chunks_plain(
        *args, prep["nb_total"], t)
    for shape in ((4, 4, 64), (4, 4, 0), (32, 2, 64), (1, 8, 8),
                  (16, 1, 4096)):
        zk = torch.zeros_like(zp)
        ok_k = torch.empty_like(ok_p)
        entropy_decode.launch_kernel(args[0], args[1:], t, zk, ok_k, shape)
        assert torch.equal(zk, zp) and torch.equal(ok_k, ok_p)


def test_entropy_decode_corrupt_chunk_arrays(cuda):
    imgs = np.stack([synthetic_image(128, 128, seed=s) for s in (1, 2, 3)])
    prep, args, t = _prep_args(compress_batch(imgs, 50, index_stride=16),
                               cuda)
    nb_total = prep["nb_total"]
    bad = [a.clone() for a in args]
    bad[1][3] = -7
    bad[1][5] = 2 ** 31 - 64
    ok = _decode_both_arrays(bad, nb_total, t)
    assert not ok[3] and not ok[5] and np.delete(ok, [3, 5]).all()
    keep = [k for k in range(args[1].shape[0]) if k not in (2, 7)]
    gap = [args[0]] + [a[keep].clone() for a in args[1:]]
    gap[3][-1] = nb_total - 1
    ok = _decode_both_arrays(gap, nb_total, t)
    assert not ok[-1] and ok[:-1].all()


def test_entropy_decode_table_with_16_bit_codes(cuda):
    def table(symbols):
        mincode = np.zeros(17, np.int32)
        maxcode = np.full(17, -1, np.int32)
        valptr = np.zeros(17, np.int32)
        code = 0
        for l in range(1, 17):
            valptr[l] = l - 1
            mincode[l] = maxcode[l] = code
            code = (code + 1) << 1
        return mincode, maxcode, valptr, np.asarray(symbols, np.int32)

    t = DecodeTables.from_numpy(
        table([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 15, 20, 200]),
        table([0x01, 0x02, 0x11, 0x00, 0x03, 0x21, 0xF0, 0x12, 0x04, 0x31,
               0x05, 0x41, 0x13, 0x22, 0x0A, 0x7A]),
        fast_decode_matrix(50), dequant_steps(50), device=cuda)
    rng = np.random.RandomState(16)
    words = rng.randint(0, 1 << 32, 4096, dtype=np.int64).astype(np.uint32)
    words[100:110] = 0xFFFFFFFF
    n = 64
    starts = np.arange(n, dtype=np.int64) * 2000
    starts[1] = 100 * 32
    arrays = [starts, np.full(n, 4), np.arange(n) * 4, np.zeros(n),
              np.full(n, 2 ** 31 - 1)]
    args = [torch.from_numpy(words.view(np.int32)).to(cuda)] + [
        torch.from_numpy(a.astype(np.int32)).to(cuda) for a in arrays]
    ok = _decode_both_arrays(args, 4 * n, t)
    assert not ok[1] and ok.any()


# ---- the shapes that steer place's gather -----------------------------------


def _place_both(packed, meta, nb):
    """Kernel == plain version at the exact capacity, one word short, half,
    the pipeline's retry capacity and ten times the stream; every word of
    a buffer full of ones is rewritten."""
    n = packed.shape[0]
    total = int(meta[0, -1]) + int(meta[1, -1])
    fits = -(-total // 32)
    before = place.launches
    caps = sorted({fits, max(fits - 1, 1), max(fits // 2, 1), n * 52,
                   10 * fits})
    for cap in caps:
        k = place.place(packed, meta, nb, cap)
        p = place.place_plain(packed, meta, nb, cap)
        assert all(torch.equal(x, y) for x, y in zip(k, p))
        assert [x.dtype for x in k] == [y.dtype for y in p]
        assert bool(k[3]) == (cap < fits)
        buf = torch.full((cap,), -1, dtype=torch.int32, device=packed.device)
        place.launch_kernel(packed, meta, buf)
        assert torch.equal(buf, p[0])
    assert place.launches == before + len(caps)


@pytest.mark.parametrize(
    "shape, quality",
    [((3, 40, 72), 90),       # N = 135: one ragged span
     ((3, 136, 152), 90),     # nb = 323: spans end inside images
     ((4, 128, 128), 50),     # nb = 256: spans end on image boundaries
     ((4096, 8, 8), 75),      # pad bits before every block
     ((1, 1024, 2048), 90)],  # one image, offsets past 2**24 bits
    ids=["N135", "nb323", "nb256", "one-block-images", "one-image"],
)
def test_place_shapes_equal_plain_version(cuda, shape, quality):
    imgs = np.random.RandomState(29).randint(0, 256, shape).astype(np.uint8)
    t = CodecTables.build(quality, cuda)
    blocks = _blocks(imgs, cuda).contiguous()
    nb = blocks.shape[0] // shape[0]
    zz, _, _ = exact_transform.exact_transform(blocks, t)
    packed, meta, _ = encode2.encode2(zz, t, nb, from_zz=True)
    _place_both(packed, meta, nb)


@pytest.mark.parametrize(
    "image_bits",
    [[[6] * 600] * 3,                            # six blocks a word
     [[2] * 700] * 2,                            # sixteen a word
     [[1662, 6, 27, 1662, 6, 6, 6, 9]] * 2,      # 1662 bits, phases 0 and 31
     [[6, 6, 5, 2], [6, 3, 7, 1], [2, 2, 2, 3]],  # pads share words
     [[13]]],                                    # one block
    ids=["six-a-word", "sixteen-a-word", "longest-block", "pads", "one-block"],
)
def test_place_handmade_blocks_equal_plain_version(cuda, image_bits):
    packed, meta, nb, bits = blocks_of_random_bits(image_bits, 7)
    packed = torch.from_numpy(packed.view(np.int32)).to(cuda)
    meta = torch.from_numpy(meta).to(cuda)
    _place_both(packed, meta, nb)
    cap = -(-len(bits) // 32)
    padded = np.zeros(cap * 32, np.uint8)
    padded[:len(bits)] = bits
    want = np.packbits(padded).view(">u4").astype(np.uint32)
    got = place.place(packed, meta, nb, cap)[0].cpu().numpy().view(np.uint32)
    assert np.array_equal(got, want)


# ---- the shapes that steer encode1's tile -----------------------------------


def _encode1_both(zz_bm, t, nb):
    a = encode1.encode1(zz_bm, t, nb, from_zz=True)
    b = encode1.encode1_plain(zz_bm, t, nb, from_zz=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[2].dtype == torch.bool and a[2].shape == ()
    return a


@pytest.mark.parametrize(
    "shape, quality",
    [((1, 8, 8), 90),         # one block
     ((1, 8, 1016), 90),      # N = 127: one ragged tile
     ((127, 8, 8), 75),       # nb = 1: the predictor resets at every block
     ((3, 8, 344), 90),       # N = 129, nb = 43
     ((3, 40, 72), 90),       # nb = 45: several resets a tile
     ((1, 120, 160), 50),     # nb = 300: ragged third tile
     ((3, 136, 152), 90),     # nb = 323
     ((1, 1024, 2048), 50)],  # 256 tiles
    ids=["N1", "N127", "nb1", "N129-nb43", "nb45", "nb300", "nb323",
         "one-image"],
)
def test_encode1_shapes_equal_plain_version(cuda, shape, quality):
    imgs = np.random.RandomState(31).randint(0, 256, shape).astype(np.uint8)
    t = CodecTables.build(quality, cuda)
    blocks = _blocks(imgs, cuda).contiguous()
    nb = blocks.shape[0] // shape[0]
    before = encode1.launches
    zz_bm = exact_transform.exact_transform(blocks, t)[0].T.contiguous()
    first = _encode1_both(zz_bm, t, nb)
    # one word off 16-byte alignment: the 4-byte loads, same words
    buf = torch.empty(zz_bm.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = buf[1:].view(zz_bm.shape)
    shifted.copy_(zz_bm)
    assert shifted.data_ptr() % 16
    again = _encode1_both(shifted, t, nb)
    assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    # pixel form: the plain coding of the transform kernel's coefficients
    zk = encode2.fast_coefficients(blocks, t).T.contiguous()
    a = encode1.encode1(blocks, t, nb)
    b = encode1.encode1_plain(zk, t, nb, from_zz=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert encode1.launches == before + 3


@pytest.mark.parametrize("n, nb", [(512, 64), (129, 43), (135, 45)])
def test_encode1_longest_block_and_overflow_flags(cuda, n, nb):
    rng = np.random.RandomState(3)
    t = CodecTables.build(50, cuda)
    zz = np.zeros((n, 64), np.int32)
    zz[:, 0] = np.where(np.arange(n) % 4 == 0, 1000, -1000)
    zz[:, 1:] = rng.randint(512, 1024, (n, 63)) * rng.choice([-1, 1], (n, 63))
    zz[1::2] = 0
    zz[1::2, 0] = zz[0::2, 0][: n // 2]  # difference 0, no AC: 6 bits
    _, bits, over = _encode1_both(torch.from_numpy(zz).to(cuda), t, nb)
    assert int(bits.max()) == 1662 and int(bits.min()) == 6 and not bool(over)
    for col, value in ((0, 2048), (7, 1024), (63, -1024)):
        flagged = np.zeros((n, 64), np.int32)
        flagged[n - 30, col] = value
        assert bool(_encode1_both(torch.from_numpy(flagged).to(cuda), t,
                                  nb)[2])


# ---- the shapes that steer the tensor-core transform ------------------------


@pytest.mark.parametrize(
    "shape, quality",
    [((1, 8, 8), 50),          # N = 1
     ((3, 40, 72), 90),        # N = 135: a ragged tile, 4-byte stores
     ((1, 8, 1032), 90),       # N = 129: one block in the second tile
     ((4, 256, 256), 90)],     # 16-byte loads and stores
    ids=["N1", "N135", "N129", "noise-q90"],
)
def test_exact_transform_shapes_equal_plain_version(cuda, shape, quality):
    imgs = np.random.RandomState(37).randint(0, 256, shape).astype(np.uint8)
    t = CodecTables.build(quality, cuda)
    blocks = _blocks(imgs, cuda).contiguous()
    flags = _exact_both(blocks, t, quality)
    # the same pixels 4 bytes past a 16-byte boundary: 4-byte loads
    buf = torch.empty(blocks.numel() + 16, dtype=torch.uint8, device=cuda)
    skew = (4 - buf.data_ptr()) % 16
    shifted = buf[skew:skew + blocks.numel()].view(blocks.shape)
    shifted.copy_(blocks)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert torch.equal(_exact_both(shifted, t, quality), flags)


@pytest.mark.parametrize("quality", [10, 50, 90])
@pytest.mark.parametrize("content", ["corpus", "noise"])
def test_exact_transform_equals_the_oracle_on_every_block(cuda, content,
                                                         quality):
    """The kernel's coefficients are the oracle's on every block, the
    flagged ones settled on the card, and its count is the plain
    version's; N = 49 * 1023 + 5 blocks is no multiple of the tile."""
    if content == "corpus":
        imgs = synthetic_corpus(49, 264)[:, :248]  # 31 x 33 blocks
    else:
        imgs = np.random.RandomState(quality).randint(
            0, 256, (49, 248, 264)).astype(np.uint8)
    blocks = _blocks(imgs, cuda)
    tail = torch.full((5, 64), 129, dtype=torch.uint8, device=cuda)  # ties
    blocks = torch.cat([blocks, tail]).contiguous()
    assert blocks.shape[0] % 128
    t = CodecTables.build(quality, cuda)
    flags = _exact_both(blocks, t, quality)
    _, _, plain = exact_transform.exact_transform_plain(blocks.cpu(),
                                                        CodecTables.build(
                                                            quality, "cpu"))
    assert int(exact_transform.exact_transform(blocks, t)[2]) == int(plain)
    assert int(plain) == int((flags != 0).sum()) > 0


def test_exact_encode_on_the_card_syncs_once_and_counts_flagged(cuda):
    """An exact ``compress_batch_device`` on the card opens no
    ``aten::nonzero`` and no recompute stage; its transform span counts
    the plain version's flagged blocks, read with the status."""
    from torch.profiler import ProfilerActivity, profile

    imgs = synthetic_corpus(6, 256)
    imgs[0, :8, :8] = 101  # a flat odd block: a DC tie
    want = [container.compress(im, 50, block_index=True) for im in imgs]
    compress_batch_device(imgs, 50, precision="exact", block_index=True,
                          device=cuda)  # built and warm
    before = {r.span_id for r in profiling.spans()[0]}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = compress_batch_device(imgs, 50, precision="exact",
                                    block_index=True, device=cuda)
    assert out == want
    names = {e.key for e in prof.key_averages()}
    assert "aten::nonzero" not in names
    recs = [r for r in profiling.spans()[0] if r.span_id not in before]
    assert not any(r.name == "codec.encode.recompute" for r in recs)
    (stage,) = [r for r in recs if r.name == "codec.encode.transform"]
    blocks = transform.blockify(torch.from_numpy(imgs)).reshape(-1, 64)
    _, _, plain = exact_transform.exact_transform_plain(
        blocks, CodecTables.build(50, "cpu"))
    assert stage.counts == {"flagged": int(plain)} and int(plain) > 0


def test_exact_transform_leaves_noise_blocks_unflagged(cuda):
    # dense noise at q = 90: about 2 % of the blocks hold a tie; a kernel
    # that flags more would pass every equality above all the same
    imgs = np.random.RandomState(41).randint(
        0, 256, (4, 256, 256)).astype(np.uint8)
    t = CodecTables.build(90, cuda)
    blocks = _blocks(imgs, cuda)
    flags = _exact_both(blocks, t, 90)
    assert int((flags != 0).sum()) <= 0.05 * blocks.shape[0]


def test_exact_transform_flags_the_exact_ties(cuda):
    t = CodecTables.build(50, cuda)
    blocks = torch.full((40, 64), 129, dtype=torch.uint8, device=cuda)
    assert bool(_exact_both(blocks, t, 50).all())


# ---- the shapes that steer stitch's gather ----------------------------------


def _stitch_both(words, bits, nb):
    """Kernel == plain version (stream, starts, total, status, dtypes) at
    the pipeline's retry capacity, the exact one, one word short and ten
    times the stream; every word of a buffer full of ones is rewritten,
    twice.  Returns the stream at the exact capacity."""
    n = words.shape[0]
    total = int(stitch.stitch_plain(words, bits, nb, n * 52)[2])
    fits = -(-total // 32)
    before = stitch.launches
    caps = sorted({n * 52, fits, max(fits - 1, 1), 10 * fits})
    for cap in caps:
        k = stitch.stitch(words, bits, nb, cap)
        p = stitch.stitch_plain(words, bits, nb, cap)
        assert all(torch.equal(x, y) for x, y in zip(k, p))
        assert [(x.dtype, x.shape) for x in k] == [(y.dtype, y.shape)
                                                   for y in p]
        assert int(k[3]) == (2 if cap < fits else 0)
        buf = torch.full((cap,), -1, dtype=torch.int32, device=words.device)
        for _ in range(2):
            summary = stitch.launch_kernels(words, bits, nb, buf)
            assert torch.equal(buf, p[0])
            assert int(summary[-2]) == total
    assert stitch.launches == before + len(caps)
    return stitch.stitch(words, bits, nb, fits)[0]


@pytest.mark.parametrize(
    "shape, quality",
    [((4096, 8, 8), 75),      # nb = 1: every block starts an image
     ((3, 40, 72), 90),       # N = 135: one ragged span
     ((3, 136, 152), 90),     # N = 969: image starts inside spans
     ((1, 1024, 2048), 90)],  # one image, 128 spans in one chain
    ids=["one-block-images", "N135", "nb323", "one-image"],
)
def test_stitch_shapes_equal_plain_version(cuda, shape, quality):
    imgs = np.random.RandomState(41).randint(0, 256, shape).astype(np.uint8)
    t = CodecTables.build(quality, cuda)
    blocks = _blocks(imgs, cuda).contiguous()
    nb = blocks.shape[0] // shape[0]
    words, bits, _ = encode1.encode1(blocks, t, nb)
    v1 = _stitch_both(words, bits, nb)
    # the v1 stream is the v2 stream
    packed, meta, _ = encode2.encode2(blocks, t, nb)
    assert torch.equal(place.place(packed, meta, nb, v1.shape[0])[0], v1)


@pytest.mark.parametrize(
    "image_bits",
    [[[6] * 600] * 3,                            # six blocks a word
     [[2] * 700] * 2,                            # sixteen a word
     [[1662, 6, 27, 1664, 6, 6, 6, 9]] * 2,      # full rows, phases 0 and 31
     [[6, 6, 5, 2], [6, 3, 7, 1], [2, 2, 2, 3]],  # pads share words
     [[b] for b in range(2, 300)],               # nb = 1
     [[13]]],                                    # one block
    ids=["six-a-word", "sixteen-a-word", "longest-block", "pads", "nb1",
         "one-block"],
)
def test_stitch_handmade_rows_equal_plain_version(cuda, image_bits):
    words, meta, nb, bits = blocks_of_random_bits(image_bits, 7,
                                                  from_bit0=True)
    got = _stitch_both(torch.from_numpy(words.view(np.int32)).to(cuda),
                       torch.from_numpy(meta[1]).to(cuda), nb)
    padded = np.zeros(got.shape[0] * 32, np.uint8)
    padded[:len(bits)] = bits
    want = np.packbits(padded).view(">u4").astype(np.uint32)
    assert np.array_equal(got.cpu().numpy().view(np.uint32), want)


def test_stream_handle_is_the_current_stream(cuda):
    """The handle the two redesigned wrappers launch on is the current
    stream's, also inside a ``torch.cuda.stream`` block."""
    dev = torch.zeros(1, device=cuda).device  # with its index
    assert _build.stream_handle(dev) == \
        torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert _build.stream_handle(dev) == side.cuda_stream
        packed, meta, nb, _ = blocks_of_random_bits([[13, 6, 40]], 1)
        out = place.place(torch.from_numpy(packed.view(np.int32)).to(dev),
                          torch.from_numpy(meta).to(dev), nb, 4)
    side.synchronize()
    assert int(out[2]) == 59 and not bool(out[3])


@pytest.mark.parametrize("quality", [10, 50, 90, 97, 99])
def test_auto_table_on_the_card_equals_the_oracle(cuda, quality):
    """Auto-table encode: coefficients, ``encode2`` with the run-time
    tables and ``place`` on the card (or the host container for an
    extended table); the oracle's bytes, decoded to its pixels."""
    from tinyimgcodec_tpu_torch import compress

    img = synthetic_image(61, 83, seed=70)
    before = encode2.launches_by_input["zz"]
    counted = symbol_stats.launches
    data = compress(img, quality, auto_generate_huffman_table=True,
                    device=cuda)
    assert data == container.compress(img, quality, True, block_index=True)
    assert encode2.launches_by_input["zz"] - before in (0, 1)
    assert symbol_stats.launches - counted == 1  # on either route
    assert np.array_equal(decompress(data, device=cuda),
                          container.decompress(data))


def _stats_ranges(case: str, dev) -> list:
    """The (64, n) int32 block ranges of a ``symbol_stats`` case on
    ``dev``."""
    if case.startswith("corpus"):
        quality = int(case[-2:])
        blocks = _blocks(synthetic_corpus(1, 512), dev)
        return [exact_coefficients(blocks, CodecTables.build(quality, dev))]
    if case == "noise q90":
        imgs = np.random.RandomState(72).randint(0, 256, (1, 256, 256))
        blocks = _blocks(imgs.astype(np.uint8), dev)
        return [exact_coefficients(blocks, CodecTables.build(90, dev))]
    rng = np.random.RandomState(73)
    if case == "ragged last CTA":  # 4133 blocks: 37 in the last CTA
        zz = rng.randint(-40, 41, (64, 4133)) * (rng.rand(64, 4133) < 0.2)
        return [torch.from_numpy(zz.astype(np.int32)).to(dev)]
    if case == "three ranges":
        zz = rng.randint(-300, 301, (64, 3000)) * (rng.rand(64, 3000) < 0.1)
        zz[0] = rng.randint(-1000, 1001, 3000)
        zz = torch.from_numpy(zz.astype(np.int32)).to(dev)
        return [zz[:, :1000].contiguous(), zz[:, 1000:2100].contiguous(),
                zz[:, 2100:].contiguous()]
    # every int32 value, INT_MIN too: sizes past 15, counted at 15
    zz = rng.randint(-2**31, 2**31, (64, 777), dtype=np.int64)
    zz[:, ::3] = 0
    zz[5, 7] = -2**31
    return [torch.from_numpy(zz.astype(np.int32)).to(dev)]


@pytest.mark.parametrize("case", ["corpus q50", "corpus q90", "noise q90",
                                  "ragged last CTA", "three ranges",
                                  "wide values"])
def test_symbol_stats_equals_plain_version(cuda, case):
    """The kernel's counts and maxima equal the plain version's, one
    launch a range, the DC carried from range to range."""
    ranges = _stats_ranges(case, cuda)
    before = symbol_stats.launches
    got = symbol_stats.stats_buffer(ranges)
    assert symbol_stats.launches - before == len(ranges)
    want = symbol_stats.stats_buffer([r.cpu() for r in ranges])
    assert torch.equal(got.cpu(), want)
    if case == "three ranges":  # the carried DC moved the first blocks
        alone = sum(symbol_stats.stats_buffer([r]).cpu() for r in ranges)
        assert not torch.equal(alone[:symbol_stats.DC_CATS],
                               want[:symbol_stats.DC_CATS])


def test_encode2_on_hand_made_run_time_tables_equals_plain(cuda):
    """16-bit codes and a 16-bit ZRL code (prefixes of 16, 32 and 48 bits,
    slots of up to 74 bits) through the kernel and the plain version."""
    from tinyimgcodec_tpu_torch.huffman import spec_from_lengths

    dc = {c: 16 for c in range(12)}
    dc.update({0: 3, 1: 3, 2: 3})
    ac = {(r, s): 16 for r in range(16) for s in range(1, 11)}
    ac.update({(0, 0): 2, (0, 1): 3, (15, 0): 16})
    t = CodecTables.from_spec(spec_from_lengths(dc, ac), 50, cuda)
    rng = np.random.RandomState(71)
    n = 1024
    zz = np.zeros((64, n), np.int32)
    zz[0] = rng.randint(-1023, 1024, n)
    for b in range(n):
        pos = ([1, 18, 51], [14, 63], [1, 5, 22, 39, 56],
               rng.choice(np.arange(1, 64), 40, replace=False))[b % 4]
        zz[pos, b] = rng.randint(1, 1024, len(pos)) * rng.choice(
            [-1, 1], len(pos))
    x = torch.from_numpy(zz).to(cuda)
    for nb in (64, n):
        k = encode2.encode2(x, t, nb, from_zz=True)
        p = encode2.encode2_plain(x, t, nb, from_zz=True)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        assert not bool(k[2]) and not bool(p[2])


# ---- a DC predictor carried into a block range, and the parallel paths ----


@pytest.mark.parametrize("form", ["coefficients", "pixels"])
def test_encode2_dc_init_equals_plain_version(cuda, form):
    """Each image's first predictor carried in: 0 and +-1, near +-2047, a
    difference of category 11 and one of 12 bits (the flag reads alike)."""
    imgs = np.random.RandomState(8).randint(0, 256, (3, 136, 152)).astype(
        np.uint8)
    t = CodecTables.build(90, cuda)
    blocks = _blocks(imgs, cuda).contiguous()
    nb = blocks.shape[0] // 3
    if form == "coefficients":
        zz, _, _ = exact_transform.exact_transform(blocks, t)
    else:
        zz = encode2.fast_coefficients(blocks, t)
    first = zz[0, ::nb].to(torch.int64)
    sign = torch.where(first >= 0, 1, -1)
    for init, over in ((torch.tensor([0, 1, -1], device=cuda), False),
                       (torch.tensor([2047, -2047, 2046], device=cuda), None),
                       (first - 1500 * sign, False),
                       (first - 2100 * sign, True)):
        d = init.to(torch.int32)
        x = zz if form == "coefficients" else blocks
        a = encode2.encode2(x, t, nb, from_zz=form == "coefficients",
                            dc_init=d)
        b = encode2.encode2_plain(zz, t, nb, from_zz=True, dc_init=d)
        assert all(torch.equal(p, q) for p, q in zip(a, b))
        assert over is None or bool(a[2]) == over


def test_parallel_paths_on_the_card(cuda, monkeypatch):
    """With one call's limit lowered to 37 blocks: tiled encode (both
    modes) and ``compress`` of a 100x123 image in six block ranges equal
    the oracle; the batch, sharded and stream functions equal
    ``compress_batch`` / ``decompress_batch`` on the card."""
    from tinyimgcodec_tpu_torch import compress, pipeline
    from tinyimgcodec_tpu_torch.parallel import batch, make_mesh, stream
    from tinyimgcodec_tpu_torch.parallel.tiled import encode_tiled

    img = synthetic_image(100, 123, seed=76)
    oracle = container.compress(img, 50, block_index=True)
    monkeypatch.setattr(pipeline, "MAX_PIXELS", 64 * 37)
    before = encode2.launches
    assert compress(img, 50, device=cuda) == oracle
    assert encode2.launches - before == 6
    mesh = make_mesh(device=cuda)
    end = container.parse_block_index(oracle, 208)[2]
    for assemble in ("host", "device"):
        assert encode_tiled(img, 50, mesh=mesh,
                            assemble=assemble) == oracle[:end]
    imgs = np.stack([synthetic_image(40, 48, seed=s) for s in range(5)])
    streams = compress_batch(imgs, 50, device=cuda)
    assert batch.compress_batch(imgs, 50, mesh=mesh,
                                block_index=True) == streams
    assert list(stream.compress_stream(imgs, 50, chunk=2, precision="exact",
                                       device=cuda)) == streams
    assert np.array_equal(batch.decompress_batch_sharded(streams, mesh=mesh),
                          decompress_batch(streams, device=cuda))
    assert all(np.array_equal(a, container.decompress(s)) for a, s in zip(
        stream.decompress_stream(streams, chunk=2, device=cuda), streams))


def test_adversarial_battery_on_the_card(cuda):
    """The conformance battery at 128x128 on the kernels: every check
    passes (bytes and pixels equal to the oracle, the q=99 refusal, the
    capacity edges), and every kernel ran in it."""
    from tinyimgcodec_tpu_torch import conformance

    rec = conformance.adversarial(cuda, 128)
    assert conformance.failed_names(rec) == []
    assert all(v >= 1 for v in rec["launches"].values()), rec["launches"]


def _local_mesh_results(mesh, img, imgs):
    """The tiled encode (both assemblies, exact and fast), the batch with
    the index, the sharded fast batch and the sharded decode on ``mesh``."""
    from tinyimgcodec_tpu_torch.parallel import batch
    from tinyimgcodec_tpu_torch.parallel.tiled import encode_tiled

    streams = batch.compress_batch(imgs, 50, mesh=mesh, block_index=True)
    return {
        "tiled_host": encode_tiled(img, 50, mesh=mesh),
        "tiled_device": encode_tiled(img, 50, mesh=mesh, assemble="device"),
        "tiled_fast": encode_tiled(img, 50, mesh=mesh, precision="fast"),
        "batch": streams,
        "sharded_fast": batch.compress_batch_sharded(imgs, 50, mesh=mesh),
        "decoded": batch.decompress_batch_sharded(streams, mesh=mesh),
    }


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
        else a[k] == b[k] for k in a)


def test_two_shards_on_one_card_equal_the_world_of_one(cuda):
    """A local mesh of two shards on card 0, one thread each: the bytes
    and pixels of the world of one and of the oracle; every launch is
    counted, on card 0."""
    from tinyimgcodec_tpu_torch import conformance
    from tinyimgcodec_tpu_torch.parallel import make_mesh

    img = synthetic_image(100, 123, seed=76)
    imgs = np.stack([synthetic_image(40, 48, seed=s) for s in range(5)])
    one = _local_mesh_results(make_mesh(device="cuda:0"), img, imgs)
    conformance.reset_launch_counts()
    two = _local_mesh_results(make_mesh(devices=["cuda:0", "cuda:0"]), img,
                              imgs)
    totals, by_card = (conformance.launch_counts(),
                       conformance.launch_counts_by_card())
    assert _same(two, one)
    assert two["tiled_host"] == container.compress(img, 50)
    assert two["batch"] == [container.compress(im, 50, block_index=True)
                            for im in imgs]
    for k in ("exact_transform", "encode2", "place", "entropy_decode"):
        assert by_card[k] == {0: totals[k]} and totals[k] >= 2, (k, by_card)


def test_make_mesh_spans_every_card(two_cards):
    """Outside a process group ``make_mesh()`` is a mesh over every card,
    as the JAX package's over ``jax.devices()``: card 0's bytes and
    pixels, and every card launched the encode and decode kernels."""
    from tinyimgcodec_tpu_torch import conformance
    from tinyimgcodec_tpu_torch.parallel import make_mesh

    img = synthetic_image(100, 123, seed=76)
    imgs = np.stack([synthetic_image(40, 48, seed=s) for s in range(9)])
    one = _local_mesh_results(make_mesh(device=two_cards[0]), img, imgs)
    mesh = make_mesh()
    count = torch.cuda.device_count()
    assert mesh.size == count
    conformance.reset_launch_counts()
    assert _same(_local_mesh_results(mesh, img, imgs), one)
    by_card = conformance.launch_counts_by_card()
    for k in ("exact_transform", "encode2", "place", "entropy_decode"):
        assert sorted(by_card[k]) == list(range(count)), (k, by_card)
    assert torch.cuda.current_device() == 0


def _group_mesh_on_cards(device, backend: str, cards: list[list[int]]):
    """2 processes x 2 shards (``spawn(per_rank=2)``) against one card's
    public ``compress_batch`` and ``decompress_batch`` and the oracle;
    process p's launches on ``cards[p]`` alone."""
    from tinyimgcodec_tpu_torch.parallel import spawn
    from test_torch_group_mesh import card_rank

    img = synthetic_image(100, 123, seed=76)
    imgs = np.stack([synthetic_image(40, 48, seed=s) for s in range(7)])
    exact = compress_batch(imgs, 50, device="cuda:0")
    fast = compress_batch(imgs, 50, precision="fast", device="cuda:0")
    got = spawn(card_rank, 2, backend=backend, device=device, per_rank=2,
                args=(img, imgs))
    for p, r in enumerate(got):
        assert [s for s, _ in r["shards"]] == [2 * p, 2 * p + 1]
        assert r["tiled"] == container.compress(img, 50)
        assert r["batch"] == exact == [container.compress(
            im, 50, block_index=True) for im in imgs]
        assert r["fast"] == fast
        assert np.array_equal(r["decoded"], decompress_batch(exact,
                                                             device="cuda:0"))
        for k in ("exact_transform", "encode2", "place", "entropy_decode"):
            assert sorted(r["by_card"][k]) == cards[p], (k, r["by_card"])


def test_a_group_of_two_processes_of_two_shards_on_one_card(cuda):
    """Two gloo processes of two shards each, all on card 0 (NCCL puts no
    two processes on one card): ``compress_batch``'s bytes and pixels."""
    _group_mesh_on_cards("cuda:0", "gloo", [[0], [0]])


def test_a_group_of_two_processes_of_two_cards_on_every_card(cuda):
    """Two NCCL processes of two cards each, cards 0-1 and 2-3: the same
    bytes and pixels, each card launching every kernel."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    _group_mesh_on_cards(None, "nccl", [[0, 1], [2, 3]])


@pytest.fixture
def two_cards(cuda):
    """Cards 0 and 1, card 0 current (decided here, not at import)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    assert torch.cuda.current_device() == 0
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("quality", [50, 90])
def test_kernels_on_another_card_equal_plain_versions(two_cards, quality):
    """Every wrapper launched on ``cuda:1`` from a process whose current
    card is 0 equals its plain version, and card 0's outputs bit for
    bit."""
    from tinyimgcodec_tpu_torch import conformance

    imgs = np.stack([synthetic_image(136, 200, seed=s) for s in (4, 5, 6)])
    on = [conformance.kernels_vs_plain(imgs, quality, d) for d in two_cards]
    assert conformance.failed_names(on[1]) == []
    assert on[1]["digests"] == on[0]["digests"]
    assert torch.cuda.current_device() == 0


def test_compress_on_another_card_equals_card_0(two_cards):
    """``compress`` and ``decompress`` on ``cuda:1`` give card 0's bytes
    and pixels (exact, fast, auto tables, a stream of chunks)."""
    from tinyimgcodec_tpu_torch import compress
    from tinyimgcodec_tpu_torch.parallel.stream import compress_stream

    img = synthetic_image(203, 341, seed=8)
    imgs = np.stack([synthetic_image(64, 72, seed=s) for s in range(5)])
    got = []
    for d in two_cards:
        data = [compress(img, 50, device=d),
                compress(img, 50, precision="fast", device=d),
                compress(img, 50, auto_generate_huffman_table=True, device=d),
                *compress_stream(imgs, 50, chunk=2, device=d)]
        got.append((data, decompress(data[0], device=d)))
    assert got[1][0] == got[0][0]
    assert np.array_equal(got[1][1], got[0][1])
    assert np.array_equal(got[0][1], container.decompress(got[0][0][0]))
    assert torch.cuda.current_device() == 0


def test_default_device_follows_the_current_card(two_cards):
    """With card 1 made current, ``device=None`` encodes on card 1 with
    card 1's tables (a cache keyed by an unindexed ``cuda`` would hand it
    card 0's), and gives card 0's bytes."""
    from tinyimgcodec_tpu_torch import compress

    img = synthetic_image(64, 80, seed=9)
    want = compress(img, 50, device=two_cards[0])
    try:
        torch.cuda.set_device(1)
        got = compress(img, 50)
        on_1 = CodecTables.build(50, "cuda").device
    finally:
        torch.cuda.set_device(0)
    assert got == want and on_1 == two_cards[1]


def test_bench_graph_replays_equal_eager_passes_at_the_corpus_shape(cuda):
    """``torch_bench.py``'s rows 3-5 on the card: each function captures
    its pass in a CUDA graph and raises unless the graph's output equals
    an eager pass's."""
    import torch_bench
    from tinyimgcodec_tpu_torch.corpus import synthetic_corpus

    corpus = synthetic_corpus(49, 512)
    for precision in ("fast", "exact"):
        samples, _ = torch_bench.bench_device(corpus, 50, precision, k=2,
                                              dev=cuda, reps=1)
        assert len(samples) == 1 and samples[0] > 0
    streams = compress_batch(corpus, 50, precision="fast", device=cuda)
    samples, pixels = torch_bench.bench_decode_entropy_device(
        streams, k=2, dev=cuda, reps=1)
    assert pixels.shape == corpus.shape and samples[0] > 0
    arrays = [container.decompress_to_arrays(s) for s in streams]
    _, pixels2 = torch_bench.bench_decode_device(arrays, k=2, dev=cuda,
                                                 reps=1)
    assert torch.equal(pixels, pixels2)


def test_host_entropy_leg_on_the_card_equals_the_oracle(cuda, monkeypatch):
    """The corpus streams without trailers at q=50, and eight of them at
    q=95 (AC values past int8: the outliers are added on the card): the C
    decoder writes the narrow rows on the host, they are widened on the
    card and transformed there; the pixels are the oracle's, and the
    upload is int16 DC and int8 AC."""
    from tinyimgcodec_tpu_torch import engine as tengine
    from tinyimgcodec_tpu_torch.corpus import synthetic_corpus

    uploaded = []
    real = tengine.widen_coefficients

    def spy(*args):
        uploaded.append(tuple(args[:4]))
        return real(*args)

    monkeypatch.setattr(tengine, "widen_coefficients", spy)
    corpus = synthetic_corpus(49, 512)
    for quality, images in ((50, corpus), (95, corpus[:8])):
        streams = compress_batch(images, quality, block_index=False,
                                 device=cuda)
        eng = Engine("exact", cuda)
        uploaded.clear()
        got = eng.decompress_batch(streams)
        assert eng.decode_stats == {"kernel": 0,
                                    "host_entropy": len(streams),
                                    "host_decoder": 0}
        for g, s in zip(got, streams):
            assert np.array_equal(g, container.decompress(s))
        (dc16, ac_n, idx, _), = uploaded
        assert dc16.dtype == torch.int16 and ac_n.dtype == torch.int8
        assert dc16.device.type == "cuda"
        assert (idx.numel() > 0) == (quality == 95)


@pytest.mark.parametrize("quality", [50, 95])
def test_widening_on_the_card_equals_the_cpu(cuda, quality):
    """q=95 gives |AC| > 127: the outliers are added on the card."""
    from tinyimgcodec_tpu_torch.engine import (
        compact_coefficients, widen_coefficients,
    )

    arrays = [container.decompress_to_arrays(
        container.compress(synthetic_image(64, 64, seed=s), quality))
        for s in (1, 2, 3)]
    dc = np.stack([a.dc for a in arrays])
    ac = np.stack([a.ac for a in arrays])
    narrow = compact_coefficients(dc, ac)
    assert (narrow[2].size > 0) == (quality == 95)
    wide = widen_coefficients(
        *(torch.from_numpy(x).to(cuda) for x in narrow), cuda)
    assert wide.device.type == "cuda"
    assert np.array_equal(wide.cpu().numpy(),
                          np.concatenate([dc[..., None], ac], axis=-1))


def test_encode_to_words_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """Exact: the card's words and bits == the CPU's, in one range and in
    three (the limit lowered to 24 blocks); fast: the stitched words are
    the card's own fast payload."""
    from tinyimgcodec_tpu_torch import native, pipeline
    from tinyimgcodec_tpu_torch.constants import HEADER_BYTES

    imgs = [synthetic_image(64, 64, seed=4), synthetic_image(61, 83, seed=5)]
    for cut in (False, True):
        if cut:
            monkeypatch.setattr(pipeline, "MAX_PIXELS", 64 * 24)
        for img in imgs:
            mine = Engine("exact", cuda).encode_to_words(img, 50)
            want = Engine("exact", "cpu").encode_to_words(img, 50)
            assert all(np.array_equal(a, b) for a, b in zip(mine, want))
            words, bits = Engine("fast", cuda).encode_to_words(img, 50)
            payload = compress_batch_device(
                img[None], 50, precision="fast", device=cuda)[0]
            assert native.stitch(words, bits) == payload[HEADER_BYTES:]


# ---- exact decode's transform: exact_inverse ----------------------------------


def _inverse_both(zz, h, w, quality=50, scaled=False):
    """The kernel on the card against the plain version on the CPU, on the
    same rows: pixels and count of flagged blocks equal, bit for bit.
    Returns the kernel's (pixels, count) on the CPU."""
    cuda = torch.device("cuda")
    zz = zz.to(cuda)
    before = exact_inverse.launches
    pk, nk = exact_inverse.exact_inverse(
        zz, h, w, DecodeTables.build(quality, scaled, cuda))
    assert exact_inverse.launches == before + 1
    pp, np_ = exact_inverse.exact_inverse_plain(
        zz.cpu(), h, w, DecodeTables.build(quality, scaled, "cpu"))
    assert pk.device.type == "cuda" and pk.dtype == torch.uint8
    assert nk.shape == () and nk.dtype == torch.int64
    assert torch.equal(pk.cpu(), pp)
    assert int(nk) == int(np_)
    return pk.cpu(), int(nk)


def _random_rows(seed, b, nb, dc_span=64, ac_span=8):
    """(b, nb, 64) int32 rows, DC as DPCM differences: a running DC in
    +-dc_span, a tenth of the AC nonzero in +-ac_span (most values inside
    0..255, where the floor and the tie test matter)."""
    rng = np.random.RandomState(seed)
    zz = rng.randint(-ac_span, ac_span + 1, (b, nb, 64))
    zz *= rng.rand(b, nb, 64) < 0.1
    dc = rng.randint(-dc_span, dc_span + 1, (b, nb))
    zz[..., 0] = np.diff(dc, axis=1, prepend=0)
    return torch.from_numpy(zz.astype(np.int32))


def _stream_rows(streams):
    return torch.from_numpy(np.stack([
        np.concatenate([a.dc[:, None], a.ac], axis=1)
        for a in map(container.decompress_to_arrays, streams)
    ]).astype(np.int32))


def test_exact_inverse_equals_plain_version_on_the_corpus(cuda):
    """The corpus's entropy-decoded rows at the decode call's shape: the
    kernel's pixels are the plain version's and the oracle's, its count
    the plain version's."""
    corpus = synthetic_corpus(49, 512)
    streams = compress_batch(corpus, 50, block_index=True, device=cuda)
    prep = entropy_decode.prepare_batch(streams)
    dt = DecodeTables.build(50, False, cuda)
    args = [torch.from_numpy(prep["words"].view(np.int32)).to(cuda)] + [
        torch.from_numpy(prep[k]).to(cuda) for k in (
            "chunk_start", "chunk_blocks", "chunk_block_base",
            "chunk_end_lo", "chunk_end_hi")]
    zz, ok = entropy_decode.entropy_decode_chunks(*args, prep["nb_total"],
                                                  dt)
    assert bool(ok.all())
    pix, flagged = _inverse_both(zz.reshape(49, 4096, 64), 512, 512)
    assert flagged > 0
    for i in (0, 17, 48):
        assert np.array_equal(pix[i].numpy(), container.decompress(streams[i]))


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_exact_inverse_equals_plain_version_on_random_blocks(cuda, quality):
    """200 000 blocks of random rows in five odd-shaped images (200 x 200
    blocks, cropped to 1597 x 1599)."""
    _inverse_both(_random_rows(quality, 5, 40_000), 1597, 1599, quality)


@pytest.mark.parametrize(
    "b, h, w",
    [(1, 8, 8),         # one block
     (3, 8, 8),         # one block an image: every tile starts an image
     (2, 61, 83),       # odd: the crop in both directions
     (4, 13, 200),      # one block row and a half, 25 blocks a row
     (3, 40, 360),      # 45 blocks a row: a full tile and a ragged one
     (2, 64, 520),      # 65 blocks a row; w % 16 == 8: no 16-byte stores
     (2, 72, 512),      # w % 16 == 0: 16-byte stores
     (1, 1, 1)],        # one pixel of one block
)
def test_exact_inverse_shapes_equal_plain_version(cuda, b, h, w):
    nb = -(-h // 8) * -(-w // 8)
    _inverse_both(_random_rows(b * h + w, b, nb), h, w)


def test_exact_inverse_on_unaligned_rows_and_scaled_streams(cuda):
    """Rows that do not start on 16 bytes take the 4-byte loads; a
    scaled-DCT stream's dequantization divides first, as the oracle's."""
    zz = _random_rows(7, 2, 40)
    flat = torch.zeros(zz.numel() + 1, dtype=torch.int32, device=cuda)
    flat[1:] = zz.reshape(-1).to(cuda)
    shifted = flat[1:].view(2, 40, 64)
    assert shifted.data_ptr() % 16
    _inverse_both(shifted, 40, 64)
    for qf in (0, 3):
        _inverse_both(_random_rows(qf, 3, 64), 64, 64, qf, True)


def test_exact_inverse_at_8k(cuda):
    """One 7680 x 4320 frame, 518 400 blocks: 16 200 tiles in one image,
    so the running DC crosses thousands of CTAs."""
    _inverse_both(_random_rows(8, 1, 518_400), 4320, 7680)


def test_exact_inverse_dc_sum_that_wraps(cuda):
    """DC differences whose running sum passes 2**31 and wraps in int32,
    within a tile and across tiles; the oracle agrees."""
    zz = torch.zeros((2, 96, 64), dtype=torch.int32)
    zz[..., 0] = 2 ** 31 - 1
    zz[0, 40:, 0] = torch.arange(56, dtype=torch.int32) % 5 - 2
    pix, _ = _inverse_both(zz, 64, 96)
    for i in range(2):
        want = golden.decode_arrays(golden.CodecArrays(
            height=64, width=96, quality=50, dc=zz[i, :, 0].numpy(),
            ac=zz[i, :, 1:].numpy()))
        assert np.array_equal(pix[i].numpy(), want)


def test_exact_decode_on_the_card_counts_flagged_and_opens_no_nonzero(cuda):
    """``api.decompress_batch`` of the corpus on the card: 49 images on
    the kernel leg through one ``exact_inverse`` launch, the oracle's
    pixels; traced, no ``aten::nonzero``, no recompute stage, and the
    transform span's ``flagged`` is the plain version's count."""
    from torch.profiler import ProfilerActivity, profile

    corpus = synthetic_corpus(49, 512)
    streams = compress_batch(corpus, 50, block_index=True, device=cuda)
    eng = Engine("exact", cuda)
    eng.decompress_batch(streams)  # built and warm
    before = exact_inverse.launches
    out = decompress_batch(streams)
    assert exact_inverse.launches == before + 1
    for i in (0, 24, 48):
        assert np.array_equal(out[i], container.decompress(streams[i]))
    got = eng.decompress_batch(streams)
    assert eng.decode_stats == {"kernel": 49, "host_entropy": 0,
                                "host_decoder": 0}
    assert np.array_equal(got, out)
    spans_before = {r.span_id for r in profiling.spans()[0]}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = decompress_batch(streams)
    assert np.array_equal(traced, out)
    names = {e.key for e in prof.key_averages()}
    assert "aten::nonzero" not in names
    recs = [r for r in profiling.spans()[0] if r.span_id not in spans_before]
    assert not any(r.name == "codec.decode.recompute" for r in recs)
    (stage,) = [r for r in recs if r.name == "codec.decode.transform"]
    _, plain = exact_inverse.exact_inverse_plain(
        _stream_rows(streams), 512, 512, DecodeTables.build(50, False, "cpu"))
    assert stage.counts == {"flagged": int(plain)} and int(plain) > 0
