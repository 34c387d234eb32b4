"""The decode slice as a whole on the CPU: the inverse transform against
the JAX package's, and ``decompress`` / ``decompress_batch`` (engine and
public API, ``device="cpu"``: the plain version of the entropy decode
kernel) against the float64 host oracle and the JAX package."""

import numpy as np
import pytest
import torch

import tinyimgcodec_tpu as jtic
import tinyimgcodec_tpu_torch as ttic
from tinyimgcodec_tpu import container as jcontainer
from tinyimgcodec_tpu import golden as jgolden
from tinyimgcodec_tpu.ops import transform as jtransform
from tinyimgcodec_tpu_torch import container as tcontainer
from tinyimgcodec_tpu_torch import tables as ttables
from tinyimgcodec_tpu_torch.engine import Engine
from tinyimgcodec_tpu_torch.ops import transform as ttransform

from conftest import synthetic_image

IMGS = [synthetic_image(64, 64, seed=s) for s in (81, 82, 83)]
STREAMS = [tcontainer.compress(im, 50, block_index=True) for im in IMGS]


def _zz_abs(stream):
    """(nb, 64) int32 coefficients with the running DC, from the oracle."""
    a = jcontainer.decompress_to_arrays(stream)
    dc = np.cumsum(a.dc.astype(np.int64)).astype(np.int32)
    return np.concatenate([dc[:, None], a.ac], axis=1).astype(np.int32), a


def _scaled_stream(img, qfactor=2):
    """A stream with the scaled-DCT flag (as the embedded fixed-point
    encoder writes): quality holds the qfactor shift."""
    arrays = jgolden.encode_arrays(img, 50)
    arrays.quality = qfactor
    arrays.scaled_dct = True
    return jcontainer.compress_arrays(arrays, block_index=True)


# ------------------------------------------------------------- transform


def test_undo_dpcm_equals_jax():
    rng = np.random.RandomState(1)
    zz = rng.randint(-300, 300, (2, 40, 64)).astype(np.int32)
    mine = ttransform.undo_dpcm(torch.from_numpy(zz)).numpy()
    theirs = np.asarray(jtransform.undo_dpcm(zz[..., 0], zz[..., 1:]))
    assert mine.dtype == np.int32 and np.array_equal(mine, theirs)


@pytest.mark.parametrize("quality, scaled", [(50, False), (90, False),
                                             (1, False), (2, True)])
def test_decode_tables_equal_jax(quality, scaled):
    assert np.array_equal(ttables.dequant_multipliers(quality, scaled),
                          jtransform.dequant_multipliers(quality, scaled))
    assert np.array_equal(ttables.fast_decode_matrix(quality, scaled),
                          jtransform._fast_decode_matrix(quality, scaled))


@pytest.mark.parametrize("quality", [50, 90])
def test_decode_blocks_fast_within_one_level_of_jax(quality):
    """float32 matrix product in two libraries: a pixel may land on the
    other side of a floor boundary; at most one level, on <= 0.1 % of
    pixels."""
    stream = tcontainer.compress(IMGS[0], quality)
    zz, _ = _zz_abs(stream)
    mine = ttransform.decode_blocks(torch.from_numpy(zz), quality,
                                    ttransform.FAST).numpy()
    theirs = np.asarray(jtransform.decode_blocks(zz, quality,
                                                 jtransform.FAST))
    assert mine.shape == theirs.shape == (64, 8, 8) and mine.dtype == np.uint8
    diff = np.abs(mine.astype(int) - theirs.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3


@pytest.mark.parametrize("case", ["q50", "q95", "q1", "noise", "scaled"])
def test_decode_blocks_exact_equals_the_oracle_after_recompute(case):
    rng = np.random.RandomState(2)
    if case == "scaled":
        stream = _scaled_stream(IMGS[1])
    elif case == "noise":
        stream = tcontainer.compress(
            rng.randint(0, 256, (64, 64)).astype(np.uint8), 90)
    else:
        stream = tcontainer.compress(IMGS[1], int(case[1:]))
    zz, a = _zz_abs(stream)
    want = jcontainer.decompress(stream)
    blocks, flags = ttransform.decode_blocks(
        torch.from_numpy(zz), a.quality, ttransform.EXACT,
        scaled_dct=a.scaled_dct, with_flags=True)
    assert flags.shape == (64,) and flags.dtype == torch.bool
    got = ttransform.unblockify(blocks, 64, 64).numpy()
    # unflagged blocks are already the oracle's
    keep = np.repeat(np.repeat(~flags.numpy().reshape(8, 8), 8, 0), 8, 1)
    assert np.array_equal(got[keep], want[keep])
    # and the engine's recompute settles the rest
    eng = Engine("exact", "cpu")
    assert np.array_equal(eng.decode_arrays(a), want)
    assert np.array_equal(eng.decompress(stream), want)


def test_exact_flags_mark_values_on_a_floor_boundary():
    """A flat block at quality 50: DC 16 * k decodes to exactly k * 2 + 128,
    an integer -- flagged, unless the clip absorbs it."""
    zz = np.zeros((3, 64), np.int32)
    zz[0, 0] = 4       # 136.0: on a boundary
    zz[1, 0] = 200     # far above 255.5: clipped, no flag
    zz[2, 1] = 3       # generic values
    _, flags = ttransform.decode_blocks(torch.from_numpy(zz), 50,
                                        ttransform.EXACT, with_flags=True)
    assert flags.tolist() == [True, False, False]


# ------------------------------------------------------ engine and API


def test_batch_on_the_kernel_leg_equals_oracle_and_jax():
    eng = Engine("exact", "cpu")
    out = eng.decompress_batch(STREAMS)
    assert out.shape == (3, 64, 64) and out.dtype == np.uint8
    assert eng.decode_stats == {"kernel": 3, "host_entropy": 0,
                                "host_decoder": 0}
    theirs = jtic.decompress_batch(STREAMS, backend="host")
    for i in range(3):
        assert np.array_equal(out[i], tcontainer.decompress(STREAMS[i]))
        assert np.array_equal(out[i], theirs[i])
    api = ttic.decompress_batch(STREAMS, device="cpu")
    assert np.array_equal(api, out)


@pytest.mark.parametrize("shape, quality, stride, auto",
                         [((61, 83), 50, 64, False), ((8, 8), 90, 64, False),
                          ((40, 24), 10, 4, False), ((64, 80), 75, 16, True)])
def test_decompress_one_stream_equals_jax_host(shape, quality, stride, auto):
    img = synthetic_image(*shape, seed=84)
    data = tcontainer.compress(img, quality, auto, block_index=True,
                               index_stride=stride)
    got = ttic.decompress(data, device="cpu")
    assert got.shape == shape
    assert np.array_equal(got, jtic.decompress(data, backend="host"))
    eng = Engine("exact", "cpu")
    eng.decompress(data)
    assert eng.decode_stats["kernel"] == 1


def test_cross_decoding_both_ways():
    img = synthetic_image(61, 59, seed=85)
    mine = ttic.compress(img, 50, device="cpu")
    theirs = jtic.compress(img, 50, backend="host", block_index=True)
    assert mine == theirs
    fast = ttic.compress(img, 50, device="cpu", precision="fast")
    for stream in (mine, fast):
        assert np.array_equal(ttic.decompress(stream, device="cpu"),
                              jcontainer.decompress(stream))
    jax_stream = jtic.compress(img, 80, backend="host",
                               auto_generate_huffman_table=True)
    assert np.array_equal(ttic.decompress(jax_stream, device="cpu"),
                          jtic.decompress(jax_stream, backend="host"))


def test_streams_without_a_trailer_take_the_host_entropy_leg():
    plain = [tcontainer.compress(im, 50) for im in IMGS[:2]]
    eng = Engine("exact", "cpu")
    out = eng.decompress_batch(plain)
    assert eng.decode_stats == {"kernel": 0, "host_entropy": 2,
                                "host_decoder": 0}
    for o, s in zip(out, plain):
        assert np.array_equal(o, tcontainer.decompress(s))
    off = Engine("exact", "cpu", device_entropy=False)
    assert np.array_equal(off.decompress_batch(STREAMS),
                          Engine("exact", "cpu").decompress_batch(STREAMS))
    assert off.decode_stats["host_entropy"] == 3


@pytest.mark.parametrize("bound, stats", [
    (2 * 64 + 5, {"kernel": 3, "host_entropy": 0, "host_decoder": 0}),
    (63, {"kernel": 0, "host_entropy": 3, "host_decoder": 0}),
])
def test_a_batch_over_the_block_bound_is_decoded_in_sub_batches(
        bound, stats, monkeypatch):
    """A uniform batch of more blocks than one decode launch takes is cut
    at image boundaries (here: 2 + 1 images of 64 blocks), every sub-batch
    on the kernel leg; an image that alone passes the bound takes the
    host-entropy leg.  (The bound is lowered from 2**25 blocks here.)"""
    from tinyimgcodec_tpu_torch import engine as tengine
    from tinyimgcodec_tpu_torch.ops import entropy_decode as ted

    whole = Engine("exact", "cpu").decompress_batch(STREAMS)
    totals = []
    real = tengine.entropy_decode_chunks

    def spy(*args):
        totals.append(args[-2])  # nb_total of the launch
        return real(*args)

    monkeypatch.setattr(tengine, "MAX_DECODE_BLOCKS", bound)
    monkeypatch.setattr(tengine, "entropy_decode_chunks", spy)
    eng = Engine("exact", "cpu")
    out = eng.decompress_batch(STREAMS)
    assert np.array_equal(out, whole) and out.shape == (3, 64, 64)
    assert eng.decode_stats == stats
    assert totals == ([128, 64] if stats["kernel"] else [])
    # a corrupt image in the second sub-batch goes to the host decoder
    pay_end = tcontainer.parse_block_index(STREAMS[2], 64)[2]
    for pos in range(20, pay_end, 7):
        mut = bytearray(STREAMS[2])
        mut[pos] ^= 0xFF
        prep = ted.prepare_batch([bytes(mut)])
        args = [torch.from_numpy(prep["words"].view(np.int32)),
                *torch.from_numpy(ted.chunk_table(prep))[:5]]
        _, ok = ted.entropy_decode_chunks_plain(
            *args, 64, ttables.DecodeTables.build(50, device="cpu"))
        if not bool(ok.all()):
            break
    batch = [STREAMS[0], STREAMS[1], bytes(mut)]
    out = eng.decompress_batch(batch)
    for o, d in zip(out, batch):
        assert np.array_equal(o, tcontainer.decompress(d))
    if stats["kernel"]:
        assert eng.decode_stats == {"kernel": 2, "host_entropy": 0,
                                    "host_decoder": 1}


def test_a_corrupt_stream_goes_to_the_host_decoder_alone():
    """A flipped payload byte either breaks a chunk -- that image is then
    decoded by the host decoder (the oracle's block-by-block degradation)
    while the others stay on the kernel leg -- or the codes resynchronise
    and the chunk still validates.  Either way every image equals the
    oracle, and the counters say which leg took it."""
    eng = Engine("exact", "cpu")
    pay_end = tcontainer.parse_block_index(STREAMS[1], 64)[2]
    legs = {"kernel": 0, "host_decoder": 0}
    for pos in range(20, pay_end, 23):
        mut = bytearray(STREAMS[1])
        mut[pos] ^= 0xFF
        batch = [STREAMS[0], bytes(mut), STREAMS[2]]
        out = eng.decompress_batch(batch)
        stats = eng.decode_stats
        assert stats["host_entropy"] == 0
        assert stats["kernel"] + stats["host_decoder"] == 3
        assert stats["host_decoder"] <= 1
        legs["host_decoder" if stats["host_decoder"] else "kernel"] += 1
        for o, s in zip(out, batch):
            assert np.array_equal(o, tcontainer.decompress(s))
        assert np.array_equal(out[1], jcontainer.decompress(batch[1]))
    assert legs["host_decoder"] >= 5 and legs["kernel"] >= 1


@pytest.mark.parametrize("trial", range(6))
def test_fuzzed_streams_decode_to_the_oracles_pixels(trial):
    rng = np.random.RandomState(300 + trial)
    base = tcontainer.compress(IMGS[2], 50, block_index=True, index_stride=16)
    mut = bytearray(base)
    for _ in range(rng.randint(1, 6)):
        mut[rng.randint(16, len(mut))] ^= 1 << rng.randint(0, 8)
    data = bytes(mut)
    want = tcontainer.decompress(data)
    assert np.array_equal(ttic.decompress(data, device="cpu"), want)
    half = base[: len(base) // 2]
    assert np.array_equal(ttic.decompress(half, device="cpu"),
                          tcontainer.decompress(half))


def test_mixed_shapes_return_a_list_and_mixed_qualities_a_stack():
    small = tcontainer.compress(synthetic_image(40, 24, seed=86), 50,
                                block_index=True)
    mixed = [STREAMS[0], small, STREAMS[1], STREAMS[2]]
    eng = Engine("exact", "cpu")
    out = eng.decompress_batch(mixed)
    assert isinstance(out, list) and [o.shape for o in out] == [
        (64, 64), (40, 24), (64, 64), (64, 64)]
    assert eng.decode_stats["kernel"] == 4
    for o, s in zip(out, mixed):
        assert np.array_equal(o, tcontainer.decompress(s))
    theirs = jtic.decompress_batch(mixed, backend="host")
    assert isinstance(theirs, list)
    other_q = tcontainer.compress(IMGS[0], 80, block_index=True)
    stacked = ttic.decompress_batch([STREAMS[0], other_q], device="cpu")
    assert isinstance(stacked, np.ndarray) and stacked.shape == (2, 64, 64)
    assert np.array_equal(stacked[1], tcontainer.decompress(other_q))


def test_fast_precision_decode_is_within_one_level():
    exact = ttic.decompress_batch(STREAMS, device="cpu")
    fast = ttic.decompress_batch(STREAMS, device="cpu", precision="fast")
    diff = np.abs(exact.astype(int) - fast.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3


def test_scaled_dct_stream_decodes_as_the_oracle():
    data = _scaled_stream(IMGS[0], qfactor=1)
    got = ttic.decompress(data, device="cpu")
    assert np.array_equal(got, jcontainer.decompress(data))


def test_decode_validation_and_the_device_rule():
    with pytest.raises(ValueError):
        ttic.decompress(STREAMS[0], backend="jax")
    with pytest.raises(ValueError):
        ttic.decompress_batch(STREAMS, precision="double", device="cpu")
    with pytest.raises(ValueError):
        ttic.decompress_batch([], device="cpu")
    assert np.array_equal(ttic.decompress(STREAMS[0], backend="host"),
                          tcontainer.decompress(STREAMS[0]))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttic.decompress(STREAMS[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttic.decompress_batch(STREAMS, backend="torch")
