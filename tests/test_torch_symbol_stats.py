"""Symbol statistics of one image (``ops/symbol_stats.py``) and the
auto-table encode that builds its tables from them.  On the CPU the plain
version runs: its histograms are ``huffman.symbol_counts``' on the float64
oracle's coefficients, its per-block maxima those counted block by block,
its bound on a block's bits at least ``block_bit_counts``' largest; the
engine's auto-table bytes are the host oracle's and its route
``conformance.auto_table_route``'s, with the coefficients pulled only
where the bound or an extended table asks for them."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tinyimgcodec_tpu_torch import (
    conformance, container, engine, golden, huffman, pipeline, profiling,
)
from tinyimgcodec_tpu_torch.corpus import synthetic_corpus
from tinyimgcodec_tpu_torch.engine import Engine
from tinyimgcodec_tpu_torch.ops import symbol_stats as ss

from conftest import synthetic_image
from test_torch_auto_table import CONTRAST

CORPUS = synthetic_corpus(2, 256)
NOISE = np.random.RandomState(81).randint(0, 256, (96, 128)).astype(np.uint8)
CASES = {
    **{f"corpus{i} q{q}": (CORPUS[i], q)
       for i in (0, 1) for q in (10, 50, 90, 97)},
    "contrast q97 (extended)": (CONTRAST, 97),
    "noise q50": (NOISE, 50),
    "noise q95": (NOISE, 95),
    "61x83 q50": (synthetic_image(61, 83, seed=82), 50),
    "37x45 q90": (synthetic_image(37, 45, seed=83), 90),
}


def _zz(arrays) -> torch.Tensor:
    """The oracle's arrays -> (64, nb) int32 coefficient-major, the DC
    undone from its DPCM differences."""
    zz = np.empty((64, len(arrays.dc)), np.int32)
    zz[0] = np.cumsum(arrays.dc, dtype=np.int64).astype(np.int32)
    zz[1:] = arrays.ac.T
    return torch.from_numpy(zz)


def _per_block(arrays) -> tuple[int, int]:
    """The most symbols and magnitude bits of one block, counted from the
    oracle's arrays with ``huffman.ac_symbols``."""
    nz, run, size = huffman.ac_symbols(arrays.ac)
    symbols = 2 + nz.sum(axis=1) + np.where(nz, run >> 4, 0).sum(axis=1)
    bits = golden.bits_required(arrays.dc) + np.where(nz, size, 0).sum(axis=1)
    return int(symbols.max()), int(bits.max())


def _table_counts(img, quality):
    """The engine's auto-table stream of ``img`` and its ``.table``
    counts, under a CPU profiler."""
    before = {r.span_id for r in profiling.spans()[0]}
    with profile(activities=[ProfilerActivity.CPU]):
        data = Engine("exact", "cpu").compress(img, quality, auto_table=True)
    (table,) = [r for r in profiling.spans()[0] if r.span_id not in before
                and r.name == "codec.encode.table"]
    return data, table.counts


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_stats_equal_symbol_counts_and_bound_every_block(name):
    img, quality = CASES[name]
    arrays = golden.encode_arrays(img, quality)
    stats = ss.symbol_stats([_zz(arrays)])
    dc, ac = huffman.symbol_counts(arrays.dc, arrays.ac)
    assert np.array_equal(stats.dc_counts, dc)
    assert np.array_equal(stats.ac_counts, ac)
    assert (stats.max_symbols, stats.max_magnitude_bits) == _per_block(arrays)
    spec = huffman.build_huffman_spec_from_counts(dc, ac)
    longest = int(max(spec.dc_len.max(), spec.ac_len.max()))
    assert stats.block_bits_bound(longest) >= int(
        huffman.block_bit_counts(arrays.dc, arrays.ac, spec).max())
    # the engine's bytes and route; the coefficients come to the host only
    # for an extended table (no bound of these cases passes 52 words)
    data, counts = _table_counts(img, quality)
    assert data == container.compress(img, quality, True, block_index=True)
    route = conformance.auto_table_route(img, quality)
    assert counts["host_route"] == int(route == "host")
    assert counts["coeffs_pulled"] == int(spec.extended)
    assert counts["longest"] == longest


def test_three_ranges_carry_the_dc_into_the_stats_and_the_bytes(monkeypatch):
    """An image cut into three block ranges (``MAX_PIXELS`` lowered):
    each later range's first DC is taken against the range before's last,
    so the stats of the ranges are those of the whole image, and the
    engine's bytes are the oracle's."""
    img = synthetic_image(48, 64, seed=84)
    monkeypatch.setattr(pipeline, "MAX_PIXELS", 16 * 64)
    assert len(pipeline.sub_ranges(0, 48)) == 3
    arrays = golden.encode_arrays(img, 50)
    zz = _zz(arrays)
    parts = [zz[:, a:b] for a, b in pipeline.sub_ranges(0, 48)]
    whole, cut = ss.symbol_stats([zz]), ss.symbol_stats(parts)
    assert np.array_equal(cut.dc_counts, whole.dc_counts)
    assert np.array_equal(cut.ac_counts, whole.ac_counts)
    assert (cut.max_symbols, cut.max_magnitude_bits) == (
        whole.max_symbols, whole.max_magnitude_bits)
    # without the carried DC the ranges' first blocks would count other
    # categories
    alone = [ss.symbol_stats([p]) for p in parts]
    assert not np.array_equal(sum(s.dc_counts for s in alone),
                              whole.dc_counts)
    seen = []
    monkeypatch.setattr(engine, "symbol_stats",
                        lambda zl: seen.append(len(zl)) or ss.symbol_stats(zl))
    data, counts = _table_counts(img, 50)
    assert seen == [3]
    assert data == container.compress(img, 50, True, block_index=True)
    assert conformance.auto_table_route(img, 50) == "kernel"
    assert counts["host_route"] == counts["coeffs_pulled"] == 0


@pytest.mark.parametrize("slack, route", [(0, "kernel"), (-1, "host")])
def test_a_failed_bound_pulls_and_decides_on_the_exact_bits(
        slack, route, monkeypatch):
    """With ``KERNEL_BLOCK_BITS`` between the largest block and the bound,
    the bound fails: the coefficients are pulled and the exact bit counts
    decide, as ``conformance.auto_table_route`` does."""
    img, quality = NOISE, 90
    arrays = golden.encode_arrays(img, quality)
    spec = huffman.build_huffman_spec(arrays)
    most = int(huffman.block_bit_counts(arrays.dc, arrays.ac, spec).max())
    longest = int(max(spec.dc_len.max(), spec.ac_len.max()))
    assert ss.symbol_stats([_zz(arrays)]).block_bits_bound(longest) > most
    monkeypatch.setattr(engine, "KERNEL_BLOCK_BITS", most + slack)
    monkeypatch.setattr(conformance, "KERNEL_BLOCK_BITS", most + slack)
    data, counts = _table_counts(img, quality)
    assert conformance.auto_table_route(img, quality) == route
    assert counts["host_route"] == int(route == "host")
    assert counts["coeffs_pulled"] == 1
    assert data == container.compress(img, quality, True, block_index=True)


def _too_wide(row: int, value: int) -> torch.Tensor:
    zz = torch.zeros((64, 4), dtype=torch.int32)
    zz[0] = torch.tensor([5, -3, 0, 7], dtype=torch.int32)
    zz[row, 2] = value
    return zz


@pytest.mark.parametrize("row, value", [(0, 40000), (9, -70000)])
def test_a_category_past_the_dynamic_tables_raises_as_symbol_counts(
        row, value):
    zz = _too_wide(row, value)
    dc = np.diff(zz[0].numpy(), prepend=np.int32(0)).astype(np.int32)
    ac = np.ascontiguousarray(zz[1:].numpy().T)
    with pytest.raises(ValueError) as want:
        huffman.symbol_counts(dc, ac)
    with pytest.raises(ValueError) as got:
        ss.symbol_stats([zz])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", [
    lambda: [torch.zeros((64, 4), dtype=torch.int64)],
    lambda: [torch.zeros((63, 4), dtype=torch.int32)],
    lambda: [torch.zeros((64, 0), dtype=torch.int32)],
    lambda: [],
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        ss.stats_buffer(bad())
