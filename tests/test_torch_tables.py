"""Port tables vs the JAX package's: the state carried across must be the
very same bits, whether built by the port or handed over as numpy."""

import dataclasses

import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import constants as jc
from tinyimgcodec_tpu.ops import entropy as jentropy
from tinyimgcodec_tpu.ops import transform as jtransform
from tinyimgcodec_tpu_torch import constants as tc
from tinyimgcodec_tpu_torch import tables as ttables
from tinyimgcodec_tpu_torch.tables import CodecTables


def _from_jax(quality):
    m, off = jtransform._fast_encode_matrix(quality)
    dc_comb, ac_comb, zp0, zp1, _ = jentropy._symbol_tables()
    return CodecTables.from_numpy(
        m, off[0], jtransform.dct_basis(),
        1.0 / jc.quant_divisors(quality), dc_comb, ac_comb, zp0, zp1,
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
