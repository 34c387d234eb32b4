"""Port tables vs the JAX package's: the state carried across must be the
very same bits, whether built by the port or handed over as numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import constants as jc
from tinyimgcodec_tpu.ops import entropy as jentropy
from tinyimgcodec_tpu.ops import entropy_decode as jdecode
from tinyimgcodec_tpu.ops import transform as jtransform
from tinyimgcodec_tpu_torch import constants as tc
from tinyimgcodec_tpu_torch import tables as ttables
from tinyimgcodec_tpu_torch.tables import CodecTables


def _from_jax(quality):
    m, off = jtransform._fast_encode_matrix(quality)
    dc_comb, ac_comb, zp0, zp1, _ = jentropy._symbol_tables()
    return CodecTables.from_numpy(
        m, off[0], jtransform.dct_basis(),
        jc.quant_divisors(quality), dc_comb, ac_comb, zp0, zp1,
        device="cpu",
    )


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 90, 99])
def test_build_equals_from_numpy_of_jax_arrays(quality):
    a = CodecTables.build(quality, "cpu")
    b = _from_jax(quality)
    for f in dataclasses.fields(CodecTables):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            # bit-for-bit, not merely ==
            assert x.numpy().tobytes() == y.numpy().tobytes(), f.name
        else:
            assert np.float32(x).tobytes() == np.float32(y).tobytes(), f.name


@pytest.mark.parametrize(
    "name",
    ["ZIGZAG_ORDER", "INVERSE_ZIGZAG", "LUMINANCE_QUANTIZATION_TABLE",
     "DC_CODE", "DC_CODELEN", "AC_CODE", "AC_CODELEN", "AAN_SCALES"],
)
def test_constant_arrays_equal(name):
    x, y = getattr(tc, name), getattr(jc, name)
    assert x.dtype == y.dtype
    assert np.array_equal(x, y)


def test_scalar_constants_equal():
    for name in ("EOB_CODE", "EOB_LEN", "ZRL_CODE", "ZRL_LEN",
                 "BLOCK_WORDS", "HEADER_BYTES", "FLAG_CUSTOM_TABLE",
                 "FLAG_SCALED_DCT", "MAX_SLOT_BITS", "MAX_BLOCK_BITS"):
        assert getattr(tc, name) == getattr(jc, name), name
    for q in (1, 49, 50, 99):
        assert tc.quality_to_factor(q) == jc.quality_to_factor(q)
        assert np.array_equal(tc.quant_divisors(q), jc.quant_divisors(q))


def test_symbol_tables_and_basis_equal():
    dc_comb, ac_comb, zp0, zp1, _ = jentropy._symbol_tables()
    mine = ttables.symbol_tables()
    for x, y in zip(mine, (dc_comb, ac_comb, zp0, zp1)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert ttables.dct_basis().tobytes() == jtransform.dct_basis().tobytes()
    # the kernels take ZRL and EOB from the AC table itself
    assert int(ac_comb[15 * 11]) == (jc.ZRL_CODE << 8) | jc.ZRL_LEN
    assert int(ac_comb[0]) == (jc.EOB_CODE << 8) | jc.EOB_LEN


def test_tables_are_typed_for_the_kernels():
    t = CodecTables.build(50, "cpu")
    assert t.encode_matrix.dtype == torch.float32
    assert t.encode_matrix.shape == (64, 64)
    assert t.dct_basis.dtype == torch.float64
    assert t.recip_divisors.dtype == torch.float64
    for x, n in ((t.dc_comb, 12), (t.ac_comb, 176), (t.zrl_hi, 4),
                 (t.zrl_lo, 4)):
        assert x.dtype == torch.int32 and x.shape == (n,)
        assert x.is_contiguous()


# ------------------------------------------- the decoder's first-level table


def _table_with_16_bit_codes():
    """A canonical table with one code of every length 1..16 ('0', '10',
    ..., fifteen ones and a zero): the longest codes the decoder takes,
    and the all-ones window matches none of them."""
    mincode = np.zeros(17, np.int32)
    maxcode = np.full(17, -1, np.int32)
    valptr = np.zeros(17, np.int32)
    huffval = []
    code = 0
    for l in range(1, 17):
        n = 1
        valptr[l] = len(huffval)
        mincode[l] = code
        maxcode[l] = code + n - 1
        huffval += [(l * 17) & 0xFF] * n
        code = (code + n) << 1
    return mincode, maxcode, valptr, np.asarray(huffval, np.int32)


def _dynamic_tables():
    from tinyimgcodec_tpu_torch import container
    from tinyimgcodec_tpu_torch.bitstream import BitReader
    from tinyimgcodec_tpu_torch.ops.entropy_decode import canonical_tables

    img = np.random.RandomState(3).randint(0, 256, (64, 64)).astype(np.uint8)
    data = container.compress(img, 90, True, block_index=True)
    reader = BitReader(data)
    reader.seek(16 * 8)
    return canonical_tables(container.read_huffman_table(reader))


def _decode_tables_under_test():
    dc, ac = ttables.standard_decode_tables()
    ddc, dac = _dynamic_tables()
    return {"standard-dc": dc, "standard-ac": ac, "dynamic-dc": ddc,
            "dynamic-ac": dac, "16-bit": _table_with_16_bit_codes()}


@pytest.mark.parametrize("bits", [1, 8, 9, 10, 12])
@pytest.mark.parametrize("name", ["standard-dc", "standard-ac", "dynamic-dc",
                                  "dynamic-ac", "16-bit"])
def test_first_level_lookup_equals_the_canonical_search(name, bits):
    """All 65 536 windows: the lookup's answer where it has one, else the
    canonical search from the next length on (what the kernel does), must
    be the full search's length and symbol; 'no code matches' included."""
    table = _decode_tables_under_test()[name]
    mincode, maxcode, valptr, huffval = (np.asarray(a, np.int64)
                                         for a in table)
    hv = np.zeros(256, np.int64)
    hv[: len(huffval)] = huffval
    w = np.arange(1 << 16, dtype=np.int64)
    want_len, want_sym = ttables.canonical_decode(w, table)
    lut = ttables.first_level_lookup(table, bits).astype(np.int64)
    assert lut.shape == (1 << bits,) and lut.min() >= 0
    e = lut[w >> (16 - bits)]
    length, symbol = e & 0xFF, e >> 8
    for l in range(bits + 1, 17):  # the kernel's search_long
        code = w >> (16 - l)
        hit = (length == 0) & (code <= maxcode[l])
        idx = np.clip(valptr[l] + code - mincode[l], 0, 255)
        length[hit] = l
        symbol[hit] = hv[idx[hit]]
    assert np.array_equal(length, want_len)
    assert np.array_equal(symbol, want_sym)
    if name == "16-bit":
        assert want_len[0xFFFF] == 0 and want_len[0xFFFE] == 16
        assert want_len[0x0000] == 1


@pytest.mark.parametrize("how", ["host-constants", "traced"])
@pytest.mark.parametrize("name", ["standard-dc", "standard-ac", "dynamic-dc",
                                  "dynamic-ac", "16-bit"])
def test_canonical_decode_and_lookup_equal_the_jax_symbol_rule(name, how):
    """All 65 536 windows through the JAX package's ``_decode_symbol``
    (jitted, on the CPU; its tables as host constants, the standard-table
    path there, and as traced arguments, the dynamic-table path): the same
    length and symbol as ``canonical_decode`` and as every first-level
    entry wherever a code matches.  Where none does the JAX rule falls
    back to length 16 and decodes on; the port reports length 0 and fails
    the chunk."""
    table = tuple(np.asarray(a, np.int32)
                  for a in _decode_tables_under_test()[name])
    w = np.arange(1 << 16, dtype=np.int64)
    w32 = jnp.asarray((w << 16).astype(np.uint32))
    if how == "traced":
        fn = jax.jit(lambda x, *t: jdecode._decode_symbol(x, t))
        jl, js = fn(w32, *(jnp.asarray(a) for a in table))
    else:
        jl, js = jax.jit(lambda x: jdecode._decode_symbol(x, table))(w32)
    jl, js = np.asarray(jl, np.int64), np.asarray(js, np.int64)
    length, symbol = ttables.canonical_decode(w, table)
    hit = length > 0
    assert hit.any()
    assert np.array_equal(jl[hit], length[hit])
    assert np.array_equal(js[hit], symbol[hit])
    assert (jl[~hit] == 16).all() and (symbol[~hit] == 0).all()
    if name == "16-bit":
        assert not hit[0xFFFF] and hit[:0xFFFF].all()
    e = ttables.first_level_lookup(table).astype(np.int64)[
        w >> (16 - ttables.LOOKUP_BITS)]
    short = e != 0
    assert np.array_equal(short, hit & (jl <= ttables.LOOKUP_BITS))
    assert np.array_equal(e[short] & 0xFF, jl[short])
    assert np.array_equal(e[short] >> 8, js[short])


@pytest.mark.parametrize("name", ["standard-dc", "standard-ac", "dynamic-dc",
                                  "dynamic-ac", "16-bit"])
def test_packed_lookup_fields_are_what_a_decode_step_derives(name):
    """The packed words hold, for every first-level entry, exactly what the
    plain decoder works out from (length, symbol) at each step."""
    table = _decode_tables_under_test()[name]
    entries = ttables.first_level_lookup(table).astype(np.int64)
    length, sym = entries & 0xFF, entries >> 8
    hit = length > 0
    for is_dc in (True, False):
        packed = ttables.pack_lookup(entries, is_dc).astype(np.int64)
        assert ((packed == 0) == ~hit).all()
        adv, size = packed & 31, (packed >> 5) & 15
        step, eob = (packed >> 9) & 31, (packed >> 14) & 1
        assert packed.max() < 1 << 15
        if is_dc:
            want_size = np.clip(sym, 0, 15)
            assert (step[hit] == 0).all() and (eob[hit] == 0).all()
        else:
            want_size = sym & 15
            assert np.array_equal(eob[hit], (sym[hit] == 0))
            assert np.array_equal(
                step[hit], np.where(sym[hit] == 0, 0,
                                    ((sym[hit] >> 4) & 15) + 1))
        assert np.array_equal(size[hit], want_size[hit])
        assert np.array_equal(adv[hit], (length + want_size)[hit])
        assert (adv[hit] >= 1).all() and (adv[hit] <= 31).all()


def test_canonical_decode_is_the_host_decoders_code_table():
    """The reference the lookup is held to is itself right: every Annex K
    code, followed by any bits, decodes to its symbol and length."""
    dc, ac = ttables.standard_decode_tables()
    for sym in range(12):
        l = int(tc.DC_CODELEN[sym])
        w = np.array([int(tc.DC_CODE[sym]) << (16 - l),
                      (int(tc.DC_CODE[sym]) << (16 - l)) | ((1 << (16 - l)) - 1)])
        length, symbol = ttables.canonical_decode(w, dc)
        assert (length == l).all() and (symbol == sym).all()
    for run in range(16):
        for size in range(11):
            l = int(tc.AC_CODELEN[run, size])
            if l == 0:
                continue
            w = np.array([int(tc.AC_CODE[run, size]) << (16 - l)])
            length, symbol = ttables.canonical_decode(w, ac)
            assert length[0] == l and symbol[0] == (run << 4) | size


def test_decode_tables_carry_the_lookup_and_refuse_wide_symbols():
    from tinyimgcodec_tpu_torch.tables import DecodeTables

    t = DecodeTables.build(50, False, "cpu")
    assert t.lookup.dtype == torch.int32
    assert t.lookup.shape == (2, 1 << ttables.LOOKUP_BITS)
    dc, ac = ttables.standard_decode_tables()
    for row, table, is_dc in zip(t.lookup.numpy(), (dc, ac), (True, False)):
        assert np.array_equal(row, ttables.pack_lookup(
            ttables.first_level_lookup(table), is_dc))
    t8 = DecodeTables.from_numpy(dc, ac, np.zeros((64, 64), np.float32),
                                 np.ones((8, 8)), lookup_bits=8)
    assert t8.lookup.shape == (2, 256)
    bad = (dc[0], dc[1], dc[2], np.array([0, 1, 256], np.int32))
    with pytest.raises(ValueError):
        DecodeTables.from_numpy(bad, ac, np.zeros((64, 64), np.float32),
                                np.ones((8, 8)))
    with pytest.raises(ValueError):
        ttables.first_level_lookup(dc, 13)
