"""Auto-table encode in the port (``Engine.compress(..., auto_table=True)``):
Huffman tables built at run time from the image's own coefficients, then
either the kernel route (``encode2`` from coefficients with the new
tables, ``place``) or the host container.  On the CPU the kernels' plain
versions run.  The bytes are held against the float64 oracle of both
packages, the route against a spy, the run-time tables against the JAX
package's arrays and the plain encode's bits against the JAX package's
``block_symbols`` / ``pack_blocks``."""

import jax
import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import container as jcontainer
from tinyimgcodec_tpu import huffman as jhuffman
from tinyimgcodec_tpu.ops import entropy as jentropy
from tinyimgcodec_tpu_torch import (
    container, engine, golden, huffman, pipeline,
)
from tinyimgcodec_tpu_torch.constants import ZIGZAG_ORDER, quant_divisors
from tinyimgcodec_tpu_torch.engine import KERNEL_BLOCK_BITS, Engine
from tinyimgcodec_tpu_torch.metrics import psnr
from tinyimgcodec_tpu_torch.ops.encode2 import encode2_plain
from tinyimgcodec_tpu_torch.tables import (
    CodecTables, dct_basis, fast_encode_matrix, symbol_words,
)

from conftest import synthetic_image

QUALITIES = [10, 50, 90, 97, 99]
IMAGES = {
    "64x64": synthetic_image(64, 64, seed=61),
    "61x83": synthetic_image(61, 83, seed=62),
}


def _contrast() -> np.ndarray:
    """Black and white blocks with noise: DC differences of 12 bits and
    more at q=99, so the table is ``extended``."""
    rng = np.random.RandomState(7)
    img = np.zeros((64, 64), np.uint8)
    for by in range(8):
        for bx in range(8):
            img[by * 8:(by + 1) * 8, bx * 8:(bx + 1) * 8] = (
                255 if (by + bx) % 2 else 0)
    noise = rng.randint(0, 3, img.shape).astype(np.uint8)
    return np.where(img > 0, img - noise, img + noise).astype(np.uint8)


CONTRAST = _contrast()


def _lengths_spec(dc_long: int, ac_long: int, zrl: int):
    """A hand-made canonical spec over every standard-range symbol: short
    codes for the frequent symbols, ``dc_long`` / ``ac_long`` bits for
    the rest, a ZRL code of ``zrl`` bits (0: none)."""
    dc = {c: dc_long for c in range(12)}
    dc.update({0: 3, 1: 3, 2: 3, 3: 4, 4: 4, 5: 5})
    ac = {(r, s): ac_long for r in range(16) for s in range(1, 11)}
    ac.update({(0, 0): 2, (0, 1): 3, (0, 2): 4, (1, 1): 5, (0, 3): 6})
    if zrl:
        ac[(15, 0)] = zrl
    return huffman.spec_from_lengths(dc, ac)


SPEC_16 = _lengths_spec(16, 16, 16)    # 16-bit codes, a 16-bit ZRL
SPEC_NO_ZRL = _lengths_spec(16, 16, 0)  # no ZRL code at all
# codes of 24 bits but EOB: longer than any table built from a histogram
SPEC_24 = huffman.spec_from_lengths(
    {c: 24 for c in range(12)},
    {(0, 0): 2, (15, 0): 24,
     **{(r, s): 24 for r in range(16) for s in range(1, 11)}})


def _image_with_runs(quality: int = 90) -> np.ndarray:
    """32x32 pixels whose blocks, coded at ``quality``, hold a few
    coefficients after runs of 0, 16, 32 and 48 zeros, the last one of
    size 4 (pixels made by the inverse transform of the coefficients
    wanted)."""
    rng = np.random.RandomState(68)
    patterns = [[1, 18, 51], [2, 49], [1, 3, 20, 37], [5, 54],
                [1, 2, 33, 63]]
    blocks = []
    for b in range(16):
        zz = np.zeros(64)
        zz[0] = rng.randint(-20, 21)
        pos = patterns[b % len(patterns)]
        zz[pos] = rng.randint(1, 4, len(pos)) * rng.choice([-1, 1], len(pos))
        zz[pos[-1]] = rng.choice([-1, 1]) * rng.randint(8, 16)
        co = np.zeros(64)
        co[ZIGZAG_ORDER] = zz
        pix = golden.block_idct(
            co.reshape(1, 8, 8) * quant_divisors(quality))[0] + 128
        blocks.append(np.clip(np.rint(pix), 0, 255).astype(np.uint8))
    return np.asarray(blocks).reshape(4, 4, 8, 8).transpose(
        0, 2, 1, 3).reshape(32, 32)


@pytest.fixture
def routes(monkeypatch):
    """The route each auto-table encode took, in call order (the kernel
    route codes its block ranges through ``pipeline.encode_ranges``)."""
    taken = []
    kernel, host = pipeline.encode2, container.compress_arrays

    def spy_kernel(*args, **kwargs):
        taken.append("kernel")
        return kernel(*args, **kwargs)

    def spy_host(*args, **kwargs):
        taken.append("host")
        return host(*args, **kwargs)

    monkeypatch.setattr(pipeline, "encode2", spy_kernel)
    monkeypatch.setattr(container, "compress_arrays", spy_host)
    return taken


def _auto(img, quality, routes, precision="exact"):
    """The engine's auto-table stream and the route it took."""
    data = Engine(precision, "cpu").compress(img, quality, auto_table=True)
    taken = list(routes)
    routes.clear()
    return data, taken


def _extended(img, quality) -> bool:
    return huffman.build_huffman_spec(
        golden.encode_arrays(img, quality)).extended


# ------------------------------------------------------------- the bytes


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_auto_table_bytes_equal_the_oracle_and_jax(name, quality, routes):
    img = IMAGES[name]
    got, taken = _auto(img, quality, routes)
    assert taken == ["host" if _extended(img, quality) else "kernel"]
    assert got == container.compress(img, quality, True, block_index=True)
    assert got == jcontainer.compress(img, quality, True, block_index=True)


@pytest.mark.parametrize("quality, extended", [(96, False), (97, True),
                                               (99, True)])
def test_high_contrast_takes_the_host_route_when_extended(quality, extended,
                                                          routes):
    assert _extended(CONTRAST, quality) == extended
    got, taken = _auto(CONTRAST, quality, routes)
    assert taken == ["host" if extended else "kernel"]
    assert got == container.compress(CONTRAST, quality, True,
                                      block_index=True)
    assert got == jcontainer.compress(CONTRAST, quality, True,
                                      block_index=True)


def test_block_index_and_stride_follow_the_arguments(routes):
    img = IMAGES["61x83"]
    eng = Engine("exact", "cpu")
    for kwargs in (dict(block_index=False), dict(index_stride=8)):
        got = eng.compress(img, 60, auto_table=True, **kwargs)
        assert routes == ["kernel"]
        assert got == container.compress(img, 60, True, **{
            "block_index": True, **kwargs})
        routes.clear()


@pytest.mark.parametrize("quality", [50, 90])
def test_fast_mode_is_within_one_coefficient_and_001_db(quality, routes):
    img = synthetic_image(128, 128, seed=63)
    fast, taken = _auto(img, quality, routes, precision="fast")
    assert taken == ["kernel"]
    exact = container.compress(img, quality, True, block_index=True)
    a, b = (container.decompress_to_arrays(s) for s in (fast, exact))
    za = np.concatenate([np.cumsum(a.dc)[:, None], a.ac], axis=1)
    zb = np.concatenate([np.cumsum(b.dc)[:, None], b.ac], axis=1)
    diff = np.abs(za.astype(np.int64) - zb)
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
    pf = psnr(img, container.decompress(fast))
    pe = psnr(img, container.decompress(exact))
    assert abs(pf - pe) <= 0.01


# ------------------------------------------------------------ the routes


def test_a_block_past_52_words_takes_the_host_route(routes, monkeypatch):
    """Codes of 24 bits (a hand-made table; tables built from a histogram
    stop at 16) make blocks of noise longer than the kernels' 52-word
    rows: the host container writes them, before any launch."""
    img = np.random.RandomState(64).randint(0, 256, (32, 32)).astype(np.uint8)
    arrays = golden.encode_arrays(img, 90)
    assert not SPEC_24.extended and not _extended(img, 90)
    assert huffman.block_bit_counts(arrays.dc, arrays.ac,
                                    SPEC_24).max() > KERNEL_BLOCK_BITS
    monkeypatch.setattr(engine, "build_huffman_spec_from_counts",
                        lambda *counts: SPEC_24)
    got, taken = _auto(img, 90, routes)
    assert taken == ["host"]
    assert got == container.compress_arrays(arrays, True, block_index=True,
                                            spec=SPEC_24)


@pytest.mark.parametrize("spec_name", ["16-bit codes and ZRL", "no ZRL"])
def test_hand_made_tables_on_the_kernel_route(spec_name, routes,
                                              monkeypatch):
    """Run-time tables the standard table never makes: codes of 16 bits
    (a DC put of up to 27 bits), ZRL prefixes of 16, 32 and 48 bits (slots
    of up to 74 bits), or no ZRL code at all.  The kernel route's bytes
    equal the host container's with the same table, and the stream
    decodes on the kernel leg to the oracle's pixels."""
    if spec_name == "no ZRL":
        spec, img, quality = SPEC_NO_ZRL, np.random.RandomState(65).randint(
            0, 256, (32, 32)).astype(np.uint8), 90
    else:
        spec, img, quality = SPEC_16, _image_with_runs(), 90
    arrays = golden.encode_arrays(img, quality)
    nz, run, size = huffman.ac_symbols(arrays.ac)
    runs = set((run[nz] >> 4).tolist())
    assert runs == ({0} if spec is SPEC_NO_ZRL else {0, 1, 2, 3})
    if spec is SPEC_16:  # slots of more than 64 bits: three words each
        slot = (run >> 4) * 16 + spec.ac_len[run & 15, size] + size
        assert slot[nz].max() > 64
    monkeypatch.setattr(engine, "build_huffman_spec_from_counts",
                        lambda *counts: spec)
    got, taken = _auto(img, quality, routes)
    assert taken == ["kernel"]
    assert got == container.compress_arrays(arrays, True, block_index=True,
                                            spec=spec)
    eng = Engine("exact", "cpu")
    assert np.array_equal(eng.decompress(got), golden.decode_arrays(arrays))
    assert eng.decode_stats["kernel"] == 1


# ---------------------------------------------------------- the decoding


@pytest.mark.parametrize("img, quality, leg", [
    (IMAGES["64x64"], 50, "kernel"), (IMAGES["61x83"], 97, "kernel"),
    (CONTRAST, 99, "host_entropy")])
def test_auto_table_streams_decode_on_the_expected_leg(img, quality, leg):
    data = Engine("exact", "cpu").compress(img, quality, auto_table=True)
    eng = Engine("exact", "cpu")
    out = eng.decompress(data)
    assert eng.decode_stats[leg] == 1
    oracle = golden.decode_arrays(
        container.decompress_to_arrays(data, use_native=False))
    assert np.array_equal(out, oracle)
    assert np.array_equal(out, jcontainer.decompress(data))


# ---------------------------------------------------- run-time tables


def _jax_spec(spec):
    return jhuffman.HuffmanSpec(spec.dc_code, spec.dc_len, spec.ac_code,
                                spec.ac_len)


SPECS = {
    "built from an image": lambda: huffman.build_huffman_spec(
        golden.encode_arrays(IMAGES["64x64"], 50)),
    "16-bit codes and ZRL": lambda: SPEC_16,
    "no ZRL": lambda: SPEC_NO_ZRL,
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_tables_from_a_spec_equal_those_of_the_jax_arrays(name):
    spec = SPECS[name]()
    mine = CodecTables.from_spec(spec, 50)
    m, off = fast_encode_matrix(50)
    theirs = CodecTables.from_numpy(
        m, off[0], dct_basis(), mine.divisors.numpy(),
        *symbol_words(*_jax_spec(spec).device_tables()))
    for field in ("encode_matrix", "dct_basis", "recip_divisors", "divisors",
                  "dc_comb", "ac_comb", "zrl_hi", "zrl_lo", "zigzag"):
        assert torch.equal(getattr(mine, field), getattr(theirs, field))
    assert mine.dc_offset == theirs.dc_offset
    hi = mine.zrl_hi.numpy().view(np.uint32)
    lo = mine.zrl_lo.numpy().view(np.uint32)
    if name == "no ZRL":
        assert not hi.any() and not lo.any()
    elif name == "16-bit codes and ZRL":
        c = int(spec.ac_code[15, 0])
        assert hi.tolist() == [0, c << 16, (c << 16) | c, (c << 16) | c]
        assert lo.tolist() == [0, 0, 0, c << 16]


def test_an_extended_spec_is_refused():
    spec = huffman.build_huffman_spec(golden.encode_arrays(CONTRAST, 99))
    assert spec.extended
    with pytest.raises(ValueError, match="extended"):
        CodecTables.from_spec(spec, 99)


def _run_coefficients() -> np.ndarray:
    """(64, 64) int32 coefficient-major blocks with runs of 0, 16, 32 and
    48 zeros (no slot past the JAX layout's 64 bits) and dense blocks of
    sizes up to 10."""
    rng = np.random.RandomState(66)
    zz = np.zeros((64, 64), np.int32)
    zz[0] = rng.randint(-1023, 1024, 64)
    sign = lambda n: rng.choice([-1, 1], n)
    for b in range(64):
        kind = b % 4
        if kind == 0:  # runs of 0, 16 and 32 zeros, sizes up to 10
            zz[[1, 18, 51], b] = rng.randint(1, 1024, 3) * sign(3)
        elif kind == 1:  # a run of 48 zeros, then a one-bit coefficient
            zz[[49, 63], b] = sign(2)
        elif kind == 2:  # dense
            pos = rng.choice(np.arange(1, 64), 40, replace=False)
            zz[pos, b] = rng.randint(1, 1024, 40) * sign(40)
    return zz


_JAX_BLOCKS = jax.jit(lambda dc, ac, *tabs: (
    lambda w0, w1, bits, over: (*jentropy.pack_blocks(w0, w1, bits), over)
)(*jentropy.block_symbols(dc, ac, *tabs)))


def _bits_of(rows: np.ndarray) -> np.ndarray:
    return np.unpackbits(rows.astype(">u4").view(np.uint8), axis=1)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_encode_on_run_time_tables_gives_the_jax_bits(name):
    spec = SPECS[name]()
    zz = _run_coefficients()
    if name == "no ZRL":
        zz[:, 0::4] = 0  # no run of 16 zeros or more
        zz[:, 1::4] = 0
        zz[0] = np.random.RandomState(67).randint(-1023, 1024, 64)
    packed, meta, over = encode2_plain(
        torch.from_numpy(zz), CodecTables.from_spec(spec, 50), 64,
        from_zz=True)
    assert not bool(over)
    dc = np.diff(zz[0], prepend=np.int32(0)).astype(np.int32)
    words, block_bits, jover = _JAX_BLOCKS(
        dc, np.ascontiguousarray(zz[1:].T), *_jax_spec(spec).device_tables())
    assert not bool(jover)
    meta = meta.numpy()
    assert np.array_equal(meta[1], np.asarray(block_bits))
    mine, theirs = _bits_of(packed.numpy().view(np.uint32)), _bits_of(
        np.asarray(words))
    for b in range(64):
        phase, n = meta[0, b] & 31, meta[1, b]
        assert np.array_equal(mine[b, phase:phase + n], theirs[b, :n]), b


def test_bit_writer_counts_its_bits_as_it_goes():
    """The host oracle asks ``bit_length`` once a block (the TICX offsets),
    so the writer keeps a running count; it equals the JAX package's
    writer's after every kind of write."""
    from tinyimgcodec_tpu.bitstream import BitWriter as JBitWriter
    from tinyimgcodec_tpu_torch.bitstream import BitWriter

    values = np.random.RandomState(69).randint(0, 256, 9)
    mine, theirs = BitWriter(), JBitWriter()
    for w in (mine, theirs):
        w.write_bytes(b"\x01\xff")
        w.write_int(-5)
        w.write_bitstring("1011")
        w.write_uint(7, 3)
        w.extend_packed(values, [8, 0, 3, 5, 8, 1, 0, 2, 4])
        w.write_bits(0, 0)
    assert mine.bit_length() == theirs.bit_length() == 16 + 3 + 4 + 3 + 31
    assert mine.to_bytes() == theirs.to_bytes()
