"""The engine's last two pieces on the CPU, against the JAX package's
``Engine``: the narrow coefficient upload of the host-entropy decode leg
(``compact_coefficients`` / ``widen_coefficients``, the counterpart of
``Engine._compact_coeffs``) and ``Engine.encode_to_words``.  The JAX side
runs as its own tests run it (``JAX_PLATFORMS=cpu``, no Pallas)."""

import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import container as jcontainer
from tinyimgcodec_tpu.engine import Engine as JaxEngine
from tinyimgcodec_tpu.golden import CodecArrays
from tinyimgcodec_tpu_torch import container as tcontainer
from tinyimgcodec_tpu_torch import engine as tengine
from tinyimgcodec_tpu_torch import native, pipeline
from tinyimgcodec_tpu_torch.constants import HEADER_BYTES
from tinyimgcodec_tpu_torch.engine import (
    Engine, compact_coefficients, widen_coefficients,
)
from tinyimgcodec_tpu_torch.ops import transform
from tinyimgcodec_tpu_torch.ops.exact_transform import exact_transform
from tinyimgcodec_tpu_torch.tables import CodecTables

from conftest import synthetic_image

IMGS = [synthetic_image(64, 64, seed=s) for s in (141, 142, 143)]
ODD = synthetic_image(61, 83, seed=144)


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine("exact", use_pallas=False)


def _no_trailer(img, quality=50):
    return jcontainer.compress(img, quality)  # the oracle writes none


def _outlier_set(idx, val):
    """(index, delta) pairs of the non-zero deltas, sorted: the JAX
    function pads its list with zeros at index 0."""
    idx, val = np.asarray(idx, np.int64), np.asarray(val, np.int64)
    keep = val != 0
    order = np.argsort(idx[keep], kind="stable")
    return idx[keep][order], val[keep][order]


def _coefficient_case(name):
    rng = np.random.RandomState(7)
    if name == "typical":  # a few dozen |AC| > 127 at q=95
        arrays = [jcontainer.decompress_to_arrays(_no_trailer(im, 95))
                  for im in IMGS]
        return (np.stack([a.dc for a in arrays]),
                np.stack([a.ac for a in arrays]))
    dc = rng.randint(-300, 300, (4, 64)).astype(np.int32)
    ac = rng.randint(-20, 21, (4, 64, 63)).astype(np.int32)
    if name == "outlier_dense":
        ac = rng.randint(-1023, 1024, ac.shape).astype(np.int32)
    elif name == "many_outliers":  # past 128, under ac.size // 8
        flat = ac.reshape(-1)
        at = rng.choice(flat.size, 500, replace=False)
        flat[at] = rng.choice([-1023, -500, -129, 128, 200, 1023], 500)
    elif name == "extremes":
        dc[:, ::2], dc[:, 1::2] = 2047, -2047
        ac[:, :, ::9], ac[:, :, 4::9] = 1023, -1023
    elif name == "one_image":  # (nb,) and (nb, 63), as decode_arrays has
        dc, ac = dc[0], ac[0]
        ac[3, 5] = 300
    return dc, ac


@pytest.mark.parametrize("name", ["typical", "outlier_dense", "many_outliers",
                                  "no_outliers", "extremes", "one_image"])
def test_compact_coefficients_equals_jax(name):
    dc, ac = _coefficient_case(name)
    mine = compact_coefficients(dc, ac)
    theirs = JaxEngine._compact_coeffs(dc, ac)
    for m, t in zip(mine[:2], theirs[:2]):
        assert m.dtype == t.dtype and np.array_equal(m, t)
    assert mine[2].dtype == np.int64 and mine[3].dtype == theirs[3].dtype
    got, want = _outlier_set(*mine[2:]), _outlier_set(*theirs[2:])
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    n_out = int((ac != ac.astype(np.int8)).sum())
    expect = {"no_outliers": 0, "many_outliers": 500}.get(name)
    if expect is not None:
        assert n_out == expect and len(mine[2]) == expect
    if name == "many_outliers":
        assert len(theirs[2]) == 512  # the JAX list, padded
    dense = n_out > ac.size // 8
    assert mine[1].dtype == (np.int16 if dense else np.int8)
    wide = widen_coefficients(*(torch.from_numpy(x) for x in mine), "cpu")
    assert wide.dtype == torch.int32
    assert np.array_equal(wide.numpy(),
                          np.concatenate([dc[..., None], ac], axis=-1))


def test_compact_coefficients_keeps_deltas_that_int16_cannot_hold():
    """|AC| >= 32640 (a 15-bit AC of a dynamic table) has a delta of
    32768 from its int8 wrap: the whole AC then goes as int16."""
    dc = np.zeros((1, 2), np.int32)
    ac = np.zeros((1, 2, 63), np.int32)
    ac[0, 1, 7] = 32700
    narrow = compact_coefficients(dc, ac)
    assert narrow[1].dtype == np.int16 and narrow[2].size == 0
    wide = widen_coefficients(*(torch.from_numpy(x) for x in narrow), "cpu")
    assert int(wide[0, 1, 8]) == 32700


def test_widen_refuses_tensors_on_another_device():
    narrow = [torch.from_numpy(x) for x in compact_coefficients(
        *_coefficient_case("typical"))]
    narrow[1] = narrow[1].to("meta")
    with pytest.raises(ValueError, match="on meta, expected cpu"):
        widen_coefficients(*narrow, "cpu")


def _dense_stream(seed):
    """A 64x64 stream of hand-made coefficients, |AC| up to 1023 in most
    places (the standard tables code it): the int16 form."""
    rng = np.random.RandomState(seed)
    dc = rng.randint(-40, 41, 64).astype(np.int32)
    ac = rng.randint(-1023, 1024, (64, 63)).astype(np.int32)
    return jcontainer.compress_arrays(CodecArrays(64, 64, 50, dc, ac))


@pytest.mark.parametrize("case", ["batch", "outliers", "dense", "odd"])
def test_host_entropy_leg_equals_jax_and_oracle(case, jax_engine,
                                                monkeypatch):
    """``case``: AC with no outliers; with a few (int8 + the list); dense
    (int16); one odd-shaped image."""
    if case == "odd":
        streams = [_no_trailer(ODD)]
    elif case == "dense":
        streams = [_dense_stream(s) for s in (5, 6)]
    else:
        streams = [_no_trailer(im, 95 if case == "outliers" else 50)
                   for im in IMGS]
    uploaded = []
    real = tengine.widen_coefficients

    def spy(*args):
        uploaded.append((args[1].dtype, args[2].numel()))
        return real(*args)

    monkeypatch.setattr(tengine, "widen_coefficients", spy)
    eng = Engine("exact", "cpu")
    got = eng.decompress_batch(streams)
    assert eng.decode_stats == {"kernel": 0, "host_entropy": len(streams),
                                "host_decoder": 0}
    (ac_dtype, outliers), = uploaded
    assert ac_dtype == (torch.int16 if case == "dense" else torch.int8)
    assert (outliers > 0) == (case == "outliers")
    theirs = np.asarray(jax_engine.decompress_batch(streams))
    oracle = np.stack([jcontainer.decompress(s) for s in streams])
    assert got.dtype == np.uint8 and got.shape == oracle.shape
    assert np.array_equal(got, theirs) and np.array_equal(got, oracle)


@pytest.mark.parametrize("img", [IMGS[0], ODD], ids=["64x64", "61x83"])
def test_decode_arrays_equals_jax_and_oracle(img, jax_engine):
    data = _no_trailer(img)
    arrays = tcontainer.decompress_to_arrays(data)
    got = Engine("exact", "cpu").decode_arrays(arrays)
    theirs = np.asarray(jax_engine.decode_arrays(
        jcontainer.decompress_to_arrays(data)))
    assert got.shape == img.shape
    assert np.array_equal(got, theirs)
    assert np.array_equal(got, jcontainer.decompress(data))


def _flagged_image():
    """Flat blocks of odd values (a DC of sum/128 - 64 at q=50 sits on a
    tie when the sum is 64 mod 128) between textured ones."""
    img = synthetic_image(64, 64, seed=145).copy()
    rng = np.random.RandomState(8)
    for by, bx in zip(*np.nonzero(rng.rand(8, 8) < 0.4)):
        img[8 * by:8 * by + 8, 8 * bx:8 * bx + 8] = 2 * rng.randint(0, 128) + 1
    return img


def _assert_words_equal_jax(img, jax_engine, quality=50):
    words, bits = Engine("exact", "cpu").encode_to_words(img, quality)
    jw, jb = jax_engine.encode_to_words(img, quality)
    assert words.dtype == jw.dtype == np.uint32
    assert bits.dtype == jb.dtype == np.int32
    assert words.shape == jw.shape and bits.shape == jb.shape
    assert np.array_equal(words, jw) and np.array_equal(bits, jb)
    # the stitched rows are the oracle's payload
    payload = jcontainer.compress(img, quality)[HEADER_BYTES:]
    assert native.stitch(words, bits) == payload
    return words, bits


@pytest.mark.parametrize("img", [IMGS[1], ODD], ids=["64x64", "61x83"])
def test_encode_to_words_exact_equals_jax(img, jax_engine):
    _assert_words_equal_jax(img, jax_engine)


def test_encode_to_words_exact_with_flagged_blocks(jax_engine):
    img = _flagged_image()
    blocks = transform.blockify(torch.from_numpy(img)).reshape(-1, 64)
    _, flags, _ = exact_transform(blocks, CodecTables.build(50, "cpu"))
    assert int(flags.sum()) > 0
    _assert_words_equal_jax(img, jax_engine)


def test_encode_to_words_across_block_ranges(monkeypatch, jax_engine):
    """The limit lowered to 24 blocks: ranges of 24, 24 and 16 blocks, the
    first row of the second and third coded again on the host."""
    img = _flagged_image()
    monkeypatch.setattr(pipeline, "MAX_PIXELS", 64 * 24)
    assert pipeline.sub_ranges(0, 64) == [(0, 24), (24, 48), (48, 64)]
    rows = []
    real = native.entropy_encode

    def spy(dc, ac):
        rows.append(int(dc[0]))
        return real(dc, ac)

    monkeypatch.setattr(native, "entropy_encode", spy)
    _assert_words_equal_jax(img, jax_engine)
    assert len(rows) == 2


def test_encode_to_words_fast_is_the_fast_payload(monkeypatch):
    """Fast mode: the stitched words are the port's own fast payload, cut
    into block ranges or not."""
    img = IMGS[2]
    eng = Engine("fast", "cpu")
    words, bits = eng.encode_to_words(img, 50)
    payload = pipeline.compress_batch_device(
        img[None], 50, precision="fast", device="cpu")[0][HEADER_BYTES:]
    assert native.stitch(words, bits) == payload
    monkeypatch.setattr(pipeline, "MAX_PIXELS", 64 * 24)
    cut = eng.encode_to_words(img, 50)
    assert np.array_equal(cut[0], words) and np.array_equal(cut[1], bits)


def test_encode_to_words_refuses_what_the_tables_cannot_code(jax_engine):
    noise = np.random.RandomState(0).randint(0, 256, (64, 64)).astype(
        np.uint8)
    with pytest.raises(ValueError) as theirs:
        jax_engine.encode_to_words(noise, 99)
    with pytest.raises(ValueError) as mine:
        Engine("exact", "cpu").encode_to_words(noise, 99)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("stride", [8, 16, 32])
def test_trailers_from_encode_to_words_decode_on_the_kernel_leg(stride):
    """The counterpart of the JAX package's small-strides test: a TICX
    trailer built from the block bit counts at another stride."""
    img = IMGS[0]
    _, bits = Engine("exact", "cpu").encode_to_words(img, 50)
    offsets = np.cumsum(bits, dtype=np.int64) - bits
    data = _no_trailer(img) + tcontainer.make_block_index(offsets,
                                                          stride=stride)
    eng = Engine("exact", "cpu")
    got = eng.decompress_batch([data])
    assert eng.decode_stats["kernel"] == 1
    assert np.array_equal(got[0], jcontainer.decompress(data))


def test_encode_to_words_needs_a_2d_image():
    with pytest.raises(ValueError, match="2-D"):
        Engine("exact", "cpu").encode_to_words(np.zeros((2, 8, 8), np.uint8),
                                               50)
