"""Chunk-parallel entropy decode: the port's host half (``prepare_batch``,
``canonical_tables``) field by field against the JAX package's, and the
plain version of the decode kernel against the JAX package's XLA program
(jitted, as its own tests run it) in ``zz`` and ``ok``.

The word arrays are padded to one length so that the JAX side compiles
once per chunk layout."""

import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import container as jcontainer
from tinyimgcodec_tpu.ops import entropy_decode as jed
from tinyimgcodec_tpu.ops import transform as jtransform
from tinyimgcodec_tpu_torch import container as tcontainer
from tinyimgcodec_tpu_torch import tables as ttables
from tinyimgcodec_tpu_torch.ops import entropy_decode as ted
from tinyimgcodec_tpu_torch.tables import DecodeTables

from conftest import synthetic_image

WORDS = 4096  # padded length of every word array handed to the JAX side
KEYS = ("chunk_start", "chunk_blocks", "chunk_block_base", "chunk_end_lo",
        "chunk_end_hi")


def _streams(quality=50, shape=(64, 64), stride=16, auto=False, seeds=(1, 2)):
    return [
        tcontainer.compress(synthetic_image(*shape, seed=s), quality, auto,
                            block_index=True, index_stride=stride)
        for s in seeds
    ]


def _mixed_streams(n=9):
    """``n`` or more streams of one shape and quality whose payloads'
    lengths take every residue mod 4, so every padding width occurs."""
    streams, seen = [], set()
    for seed in range(20, 80):
        s = _streams(seeds=(seed,))[0]
        streams.append(s)
        seen.add(tcontainer.parse_block_index(s, 64)[2] % 4)
        if len(streams) >= n and len(seen) == 4:
            return streams
    raise AssertionError("no seed range gives all four residues")


@functools.cache
def _jax_fn(nb_total, stride, custom):
    def run(w, s, b, bb, lo, hi, *tabs):
        tables = jed.unflatten_tables(tabs) if custom else None
        return jed.entropy_decode_chunks(
            w, s, b, bb, lo, hi, nb_total=nb_total, stride=stride,
            tables=tables)
    return jax.jit(run)


def _jax_decode(prep):
    words = np.zeros(WORDS, np.uint32)
    words[: len(prep["words"])] = prep["words"]
    custom = prep["tables"] is not None
    tabs = tuple(jnp.asarray(a) for a in jed.flatten_tables(prep["tables"])
                 ) if custom else ()
    zz, ok, exhausted = _jax_fn(prep["nb_total"], prep["stride"], custom)(
        jnp.asarray(words), *(jnp.asarray(prep[k]) for k in KEYS), *tabs)
    assert not np.asarray(exhausted).any()
    return np.asarray(zz), np.asarray(ok)


def _port_decode(prep, quality=50):
    t = DecodeTables.build(quality, False, "cpu", huffman=prep["tables"])
    zz, ok = ted.entropy_decode_chunks(
        torch.from_numpy(prep["words"].view(np.int32)),
        *(torch.from_numpy(prep[k]) for k in KEYS), prep["nb_total"], t)
    return zz.numpy(), ok.numpy()


def _assert_prep_equal(mine, theirs):
    assert (mine is None) == (theirs is None)
    if mine is None:
        return
    assert mine.keys() == theirs.keys()
    for k in theirs:
        if k == "tables":
            assert (mine[k] is None) == (theirs[k] is None)
            if mine[k] is not None:
                for a, b in zip(jed.flatten_tables(mine[k]),
                                jed.flatten_tables(theirs[k])):
                    assert a.dtype == b.dtype and np.array_equal(a, b)
        elif isinstance(mine[k], np.ndarray):
            assert mine[k].dtype == theirs[k].dtype, k
            assert np.array_equal(mine[k], theirs[k]), k
        else:
            assert mine[k] == theirs[k], k


# ---------------------------------------------------------------- host half


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(quality=95), dict(shape=(60, 52), stride=64),
     dict(stride=8), dict(auto=True, seeds=(3, 3)),
     dict(auto=True, seeds=(3, 4)),  # two tables: not one batch
     dict(seeds=(5,)), "mixed-sizes"],
    ids=["q50", "q95", "odd", "stride8", "auto", "auto-mixed", "single",
         "mixed-sizes"],
)
def test_prepare_batch_equals_jax_field_by_field(kw):
    streams = _mixed_streams() if kw == "mixed-sizes" else _streams(**kw)
    _assert_prep_equal(ted.prepare_batch(streams), jed.prepare_batch(streams))


def test_prepare_batch_admission_rules():
    a, b = _streams()
    assert ted.prepare_batch([a, b]) is not None
    no_trailer = tcontainer.compress(synthetic_image(64, 64, seed=1), 50)
    other_shape = _streams(shape=(64, 72))[0]
    other_q = _streams(quality=60)[0]
    other_stride = _streams(stride=32)[0]
    auto = _streams(auto=True)[0]
    for bad in ([a, no_trailer], [a, other_shape], [a, other_q],
                [a, other_stride], [a, auto], [a[:10]], [a[: len(a) // 2]],
                []):
        assert ted.prepare_batch(bad) is None
        if bad:
            assert jed.prepare_batch(bad) is None
    # each trailer refusal in a stream after the first: the second of
    # nine, and the last
    batch = _mixed_streams()
    assert ted.prepare_batch(batch) is not None
    for fix in _TRAILER_REFUSALS:
        for i in (1, len(batch) - 1):
            bad = list(batch)
            bad[i] = _with_trailer(batch[i], fix)
            assert ted.prepare_batch(bad) is None, (fix.__name__, i)
            assert jed.prepare_batch(bad) is None, (fix.__name__, i)


def _with_trailer(data: bytes, fix) -> bytes:
    """``data`` with its TICX trailer rewritten after ``fix(off, fields,
    payload_bits)`` edits the offsets ((n,) int64) and the fields (a dict
    of ``lg_stride`` and ``n``; the first ``n`` offsets are written)."""
    body_len = struct.unpack_from("<I", data, len(data) - 8)[0]
    start = len(data) - 8 - body_len
    _, lg_stride, _, n = struct.unpack_from("<BBHI", data, start)
    off = np.frombuffer(data, "<u4", n, start + 8).astype(np.int64)
    fields = {"lg_stride": lg_stride, "n": n}
    fix(off, fields, (start - 16) * 8)
    body = struct.pack("<BBHI", 1, fields["lg_stride"], 0, fields["n"])
    body += off[:fields["n"]].astype("<u4").tobytes()
    return data[:start] + body + struct.pack("<I", len(body)) + b"TICX"


def _offsets_out_of_order(off, fields, payload_bits):
    off[2] = off[1]


def _first_offset_not_0(off, fields, payload_bits):
    off[0] = 1


def _offset_past_the_payload(off, fields, payload_bits):
    off[-1] = payload_bits


def _bad_stride(off, fields, payload_bits):
    fields["lg_stride"] += 1


def _bad_count(off, fields, payload_bits):
    fields["n"] -= 1


_TRAILER_REFUSALS = (_offsets_out_of_order, _first_offset_not_0,
                     _offset_past_the_payload, _bad_stride, _bad_count)


def test_prepare_batch_rejects_a_trailer_offset_past_the_custom_payload():
    """An offset inside the table-bits over-count window passes the loose
    structural parse and must still be refused (JAX: the same)."""
    from tinyimgcodec_tpu_torch.bitstream import BitReader

    data = bytearray(_streams(auto=True, stride=8, seeds=(12,))[0])
    body_len = struct.unpack_from("<I", data, len(data) - 8)[0]
    start = len(data) - 8 - body_len
    reader = BitReader(bytes(data))
    reader.seek(16 * 8)
    tcontainer.read_huffman_table(reader)
    bogus = (start - 16) * 8 - 1
    assert bogus >= start * 8 - reader.tell()
    n_off = (body_len - 8) // 4
    struct.pack_into("<I", data, start + 8 + 4 * (n_off - 1), bogus)
    assert tcontainer.parse_block_index(bytes(data), 64) is not None
    assert ted.prepare_batch([bytes(data)]) is None
    assert jed.prepare_batch([bytes(data)]) is None


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(shape=(60, 52), stride=64), dict(stride=8),
     dict(shape=(8, 8), stride=1, seeds=(1, 2, 3)),
     dict(shape=(40, 24), stride=4, seeds=(4, 5, 6)),
     dict(auto=True, seeds=(3, 3)), "corrupt-trailer", "mixed-sizes"],
    ids=["q50", "odd", "stride8", "one-block-images", "ragged-last-chunk",
         "auto", "corrupt-trailer", "mixed-sizes"],
)
def test_prepare_batch_chunks_tile_the_blocks(kw):
    """The chunks cover every block once: chunk k begins where chunk k - 1
    ends, from block 0 to ``nb_total``, every chunk non-empty -- also when
    a trailer's offsets are garbage (they move ``chunk_start`` only).  The
    six chunk arrays are the int32 rows of one C-contiguous (6, C) table,
    in ``CHUNK_KEYS`` order."""
    if kw == "mixed-sizes":
        streams = _mixed_streams()
    elif kw == "corrupt-trailer":
        streams = _streams()
        data = bytearray(streams[0])
        start = tcontainer.parse_block_index(streams[0], 64)[2]
        (off2,) = struct.unpack_from("<I", data, start + 8 + 4 * 2)
        struct.pack_into("<I", data, start + 8 + 4 * 2, off2 + 9)
        streams = [bytes(data), streams[1]]
    else:
        streams = _streams(**kw)
    prep = ted.prepare_batch(streams)
    assert prep is not None
    base = prep["chunk_block_base"].astype(np.int64)
    blocks = prep["chunk_blocks"].astype(np.int64)
    assert base[0] == 0 and (blocks >= 1).all()
    assert np.array_equal(base[1:], base[:-1] + blocks[:-1])
    assert base[-1] + blocks[-1] == prep["nb_total"]
    assert prep["nb_total"] == len(streams) * prep["nb_per_image"]
    table = ted.chunk_table(prep)
    c = len(prep["chunk_start"])
    assert table.shape == (6, c) and table.dtype == np.int32
    assert table.flags.c_contiguous
    for row, k in enumerate(ted.CHUNK_KEYS):
        assert prep[k].dtype == np.int32 and prep[k].shape == (c,)
        assert prep[k].base is table
        assert prep[k].ctypes.data == table[row].ctypes.data


def test_launch_shape_is_a_function_of_the_sizes_alone():
    for nchunks, nwords in ((1, 3), (49, 4000), (3136, 226_000),
                            (3136, 860_000), (12_544, 900_000),
                            (200_000, 5_000_000), (64, 200_000)):
        cpw, warps, stage = ted.launch_shape(nchunks, nwords)
        assert (cpw, warps) == (ted.CHUNKS_PER_WARP, ted.WARPS_PER_CTA)
        assert stage % 4 == 0 and 64 <= stage <= ted.MAX_STAGE_WORDS
        # the whole CTA fits the 227 KB a block may use
        shared = 4 * (stage + 616 + 2 * 4096)
        assert shared <= 232_448
    # the window follows the batch's density, up to the cap
    assert (ted.launch_shape(3136, 226_000)[2]
            < ted.launch_shape(3136, 860_000)[2]
            <= ted.launch_shape(64, 200_000)[2] == ted.MAX_STAGE_WORDS)


def test_standard_decode_tables_equal_jax():
    for mine, theirs in zip(ttables.standard_decode_tables(),
                            jed._decode_tables()):
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_canonical_tables_equal_jax_and_admission():
    from tinyimgcodec_tpu_torch.bitstream import BitReader

    data = _streams(auto=True, seeds=(7,))[0]
    reader = BitReader(data)
    reader.seek(16 * 8)
    parsed = tcontainer.read_huffman_table(reader)
    mine, theirs = ted.canonical_tables(parsed), jed.canonical_tables(parsed)
    for a, b in zip(jed.flatten_tables(mine), jed.flatten_tables(theirs)):
        assert np.array_equal(a, b)
    ok = {"DC": {0: "00", 1: "01", 2: "10"}, "AC": {(0, 0): "0"}}
    cases = [
        ok,
        {"DC": {0: "00", 1: "10"}, "AC": {(0, 0): "0"}},       # not canonical
        {"DC": {0: "0" * 17}, "AC": {(0, 0): "0"}},            # 17-bit code
        {"DC": {12: "0"}, "AC": {(0, 0): "0"}},                # DC category 12
        {"DC": {0: "0"}, "AC": {(0, 11): "0"}},                # AC size 11
        {"DC": {}, "AC": {(0, 0): "0"}},                       # empty
    ]
    for case in cases:
        m, t = ted.canonical_tables(case), jed.canonical_tables(case)
        assert (m is None) == (t is None)
    assert ted.canonical_tables(ok) is not None
    assert all(ted.canonical_tables(c) is None for c in cases[1:])


def test_decode_tables_from_the_jax_arrays_equal_the_ports_own():
    """The state carried across: both sides built from the same arrays."""
    for quality, scaled in ((50, False), (85, False), (2, True)):
        dc, ac = jed._decode_tables()
        theirs = DecodeTables.from_numpy(
            dc, ac, jtransform._fast_decode_matrix(quality, scaled),
            jtransform.dequant_multipliers(quality, scaled))
        mine = DecodeTables.build(quality, scaled, "cpu")
        assert torch.equal(mine.huffman, theirs.huffman)
        assert torch.equal(mine.fast_matrix, theirs.fast_matrix)
        assert torch.equal(mine.exact_matrix, theirs.exact_matrix)
        assert mine.huffman.shape == (2, 307)


# -------------------------------------------------------------- device half


@pytest.mark.parametrize(
    "kw",
    [dict(quality=1), dict(quality=50), dict(quality=95),
     dict(shape=(60, 52), stride=64), dict(stride=8),
     dict(auto=True, seeds=(3, 3))],
    ids=["q1", "q50", "q95", "odd", "stride8", "auto"],
)
def test_valid_streams_equal_jax_and_the_oracle(kw):
    streams = _streams(**kw)
    prep = ted.prepare_batch(streams)
    zz, ok = _port_decode(prep, kw.get("quality", 50))
    zz_j, ok_j = _jax_decode(prep)
    assert ok.all() and ok_j.all()
    assert zz.dtype == np.int32 and np.array_equal(zz, zz_j)
    base = 0
    for s in streams:
        a = tcontainer.decompress_to_arrays(s)
        nb = len(a.dc)
        assert np.array_equal(a.dc, zz[base: base + nb, 0])
        assert np.array_equal(a.ac, zz[base: base + nb, 1:])
        base += nb


def _compare_corrupt(streams):
    prep = ted.prepare_batch(streams)
    _assert_prep_equal(prep, jed.prepare_batch(streams))
    if prep is None:
        return None
    zz, ok = _port_decode(prep)
    zz_j, ok_j = _jax_decode(prep)
    assert np.array_equal(ok, ok_j)
    # chunks that pass validation hold the same coefficients in both
    good = np.repeat(ok, prep["chunk_blocks"])
    assert np.array_equal(zz[good], zz_j[good])
    return ok


@pytest.mark.parametrize("trial", range(8))
def test_bit_flips_give_the_same_ok_as_jax(trial):
    good = _streams()
    rng = np.random.RandomState(100 + trial)
    mut = bytearray(good[1])
    pay_end = tcontainer.parse_block_index(good[1], 64)[2]
    for _ in range(rng.randint(1, 4)):
        mut[rng.randint(16, pay_end)] ^= 1 << rng.randint(0, 8)
    _compare_corrupt([good[0], bytes(mut)])


@pytest.mark.parametrize("trial", range(4))
def test_flipped_bytes_give_the_same_ok_as_jax(trial):
    good = _streams()
    rng = np.random.RandomState(200 + trial)
    mut = bytearray(good[0])
    pay_end = tcontainer.parse_block_index(good[0], 64)[2]
    for _ in range(2):
        mut[rng.randint(16, pay_end)] ^= 0xFF
    ok = _compare_corrupt([bytes(mut), good[1]])
    assert ok is not None and ok[4:].all()  # the other image is untouched


def test_truncated_payload_with_the_trailer_kept():
    """Payload cut short but the trailer re-attached: the last chunks run
    off the data; both sides fail exactly those."""
    good = _streams()
    start = tcontainer.parse_block_index(good[0], 64)[2]
    cut = good[0][: start - 24] + good[0][start:]
    ok = _compare_corrupt([cut, good[1]])
    if ok is not None:
        assert not ok[:4].all() and ok[4:].all()


def test_trailer_offset_off_by_one():
    good = _streams()
    data = bytearray(good[0])
    start = tcontainer.parse_block_index(good[0], 64)[2]
    (off2,) = struct.unpack_from("<I", data, start + 8 + 4 * 2)
    struct.pack_into("<I", data, start + 8 + 4 * 2, off2 + 1)
    ok = _compare_corrupt([bytes(data), good[1]])
    assert ok is not None
    # chunk 1 ends one bit early for its bound, chunk 2 starts mid-code
    assert not ok[1] and ok[0] and ok[3] and ok[4:].all()


def test_garbage_chunks_end_and_write_nothing_outside():
    """Random words with made-up chunk arrays: every chunk fails or ends in
    bounds, nothing raises, and blocks outside [0, nb_total) are refused."""
    rng = np.random.RandomState(5)
    words = torch.from_numpy(
        rng.randint(-2**31, 2**31, 64, dtype=np.int64).astype(np.int32))
    t = DecodeTables.build(50, False, "cpu")

    def arr(*v):
        return torch.tensor(v, dtype=torch.int32)

    zz, ok = ted.entropy_decode_chunks(
        words, arr(0, 500, 2040, 100, -5), arr(8, 8, 8, 4, 1),
        arr(0, 8, 16, 30, 0), arr(0, 0, 0, 0, 0),
        arr(10**6, 10**6, 10**6, 10**6, 10**6), 32, t)
    assert zz.shape == (32, 64)
    assert not ok[3] and not ok[4]  # blocks 32.. and a negative cursor
    all_ones = torch.full((8,), -1, dtype=torch.int32)
    _, ok = ted.entropy_decode_chunks(
        all_ones, arr(0), arr(1), arr(0), arr(0), arr(256), 1, t)
    assert not ok[0]  # nine 1-bits match no DC code


def test_wrapper_validates_and_counts_no_launch_on_cpu():
    prep = ted.prepare_batch(_streams())
    before = ted.launches
    _port_decode(prep)
    assert ted.launches == before
    t = DecodeTables.build(50, False, "cpu")
    args = [torch.from_numpy(prep[k]) for k in KEYS]
    with pytest.raises(ValueError):
        ted.entropy_decode_chunks(
            torch.from_numpy(prep["words"].astype(np.int64)), *args, 128, t)
    with pytest.raises(ValueError):
        ted.entropy_decode_chunks(
            torch.from_numpy(prep["words"].view(np.int32)), args[0][:-1],
            *args[1:], 128, t)
    with pytest.raises(ValueError):
        ted.entropy_decode_chunks(
            torch.from_numpy(prep["words"].view(np.int32)), *args, 0, t)
