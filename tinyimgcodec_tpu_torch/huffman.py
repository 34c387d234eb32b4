"""Dynamic Huffman table construction (canonical, length-limited).

Replaces the reference's raw-tree construction (huffman.py:112-194) with a
canonical, 16-bit length-limited code constructor: the reference assigns raw
tree-depth codes with no length limiting, so a skewed symbol distribution can
emit codes its own 16-bit-capped reader (huffman.py:69-73) cannot decode
(SURVEY 3.5).  Canonical codes also serialize compactly and decode with the
same LUT machinery as the static Annex K tables.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import Counter

import numpy as np

from .constants import AC, DC
from .golden import CodecArrays, bits_required

MAX_CODE_LENGTH = 16

# Extended dynamic-table symbol range.  The standard Annex-K tables stop at
# DC category 11 / AC size 10; qualities 97-99 push quantizer divisors
# below 1.0, so coefficients can need categories up to ~13 (the reference
# crashes there with a bare KeyError, codec.py:153-162).  The container's
# custom-table wire format stores category and size as u4, so dynamic
# tables extend cleanly to 16 categories / 16 sizes.
DC_CATS = 16   # dynamic-table DC categories (standard tables: 12)
AC_SIZES = 16  # dynamic-table AC sizes per run (standard tables: 11)
STD_DC_CATS = 12
STD_AC_SIZES = 11


def _huffman_code_lengths(freqs: dict, max_len: int = MAX_CODE_LENGTH) -> dict:
    """Symbol -> code length, optimal then length-limited.

    Deterministic: ties broken by symbol insertion order.  Length limiting
    uses the JPEG Annex K.3 style adjustment (move leaves up the tree).
    """
    symbols = list(freqs)
    if not symbols:
        return {}
    if len(symbols) == 1:
        return {symbols[0]: 1}
    heap: list[tuple[int, int, tuple]] = []
    for order, sym in enumerate(symbols):
        heapq.heappush(heap, (freqs[sym], order, (sym,)))
    next_order = len(symbols)
    depth: dict = {s: 0 for s in symbols}
    while len(heap) > 1:
        f1, _, g1 = heapq.heappop(heap)
        f2, _, g2 = heapq.heappop(heap)
        merged = g1 + g2
        for s in merged:
            depth[s] += 1
        heapq.heappush(heap, (f1 + f2, next_order, merged))
        next_order += 1

    # Length-limit: count codes per length, push overlong leaves up.
    counts = Counter(depth.values())
    bits = [counts.get(l, 0) for l in range(0, max(counts) + 1)]
    while len(bits) - 1 > max_len:
        top = len(bits) - 1
        # Remove two leaves from the deepest level: one moves to top-1's
        # sibling slot, pairing with a leaf pulled down from the nearest
        # shallower populated level.
        j = top - 2
        while bits[j] == 0:
            j -= 1
        bits[top] -= 2
        bits[top - 1] += 1
        bits[j + 1] += 2
        bits[j] -= 1
        while bits and bits[-1] == 0:
            bits.pop()

    # Reassign lengths canonically: sort symbols by (orig length, freq desc
    # is implicit in length; tie-break by symbol repr for determinism).
    ordered = sorted(depth, key=lambda s: (depth[s], repr(s)))
    lengths: dict = {}
    idx = 0
    for l, n in enumerate(bits):
        for _ in range(n):
            lengths[ordered[idx]] = l
            idx += 1
    return lengths


def _canonical_codes(lengths: dict) -> dict:
    """Symbol -> (code, length) with canonical ordering (length, symbol)."""
    ordered = sorted(lengths, key=lambda s: (lengths[s], repr(s)))
    out: dict = {}
    code = 0
    prev_len = 0
    for sym in ordered:
        l = lengths[sym]
        code <<= l - prev_len
        out[sym] = (code, l)
        code += 1
        prev_len = l
    return out


@dataclasses.dataclass
class HuffmanSpec:
    """Numeric code tables for one stream (DC categories + AC (run,size))."""

    dc_code: np.ndarray  # (DC_CATS,) uint32
    dc_len: np.ndarray   # (DC_CATS,) int32 (0 = symbol absent)
    ac_code: np.ndarray  # (16, AC_SIZES) uint32
    ac_len: np.ndarray   # (16, AC_SIZES) int32

    def string_tables(self) -> dict[str, dict]:
        dc = {
            cat: format(int(self.dc_code[cat]), f"0{int(self.dc_len[cat])}b")
            for cat in range(DC_CATS)
            if self.dc_len[cat]
        }
        ac = {}
        for run in range(16):
            for size in range(AC_SIZES):
                l = int(self.ac_len[run, size])
                if l:
                    ac[(run, size)] = format(
                        int(self.ac_code[run, size]), f"0{l}b"
                    )
        return {DC: dc, AC: ac}

    @property
    def extended(self) -> bool:
        """True when any symbol falls outside the standard-table range
        (DC category >= 12 or AC size >= 11) — the device entropy layout
        cannot represent those; encode via the host container path."""
        return bool(
            self.dc_len[STD_DC_CATS:].any()
            or self.ac_len[:, STD_AC_SIZES:].any()
        )

    def device_tables(self):
        """Standard-range views for the device entropy kernels, which use
        the (12,) / (16, 11) merged-table layout."""
        return (
            self.dc_code[:STD_DC_CATS],
            self.dc_len[:STD_DC_CATS].astype(np.uint32),
            np.ascontiguousarray(self.ac_code[:, :STD_AC_SIZES]),
            np.ascontiguousarray(
                self.ac_len[:, :STD_AC_SIZES]
            ).astype(np.uint32),
        )


def ac_symbols(ac: np.ndarray):
    """(n, 63) zig-zag AC rows -> (nonzero mask, zeros since the previous
    nonzero coefficient (valid where nonzero), size) arrays."""
    n = ac.shape[0]
    nz = ac != 0
    pos = np.arange(63, dtype=np.int64)
    marked = np.where(nz, pos, np.int64(-1))
    prev = np.maximum.accumulate(marked, axis=1)
    prev = np.concatenate(
        [np.full((n, 1), -1, np.int64), prev[:, :-1]], axis=1
    )
    return nz, pos - prev - 1, bits_required(ac)


def symbol_counts(dc: np.ndarray, ac: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized symbol histograms over all blocks.

    dc: (n,) DPCM'd DC diffs; ac: (n, 63) zig-zag AC rows.  Returns
    (dc_counts (DC_CATS,), ac_counts (16 * AC_SIZES,)) where ac index =
    run * AC_SIZES + size (ZRL prefixes at 15 * AC_SIZES, one EOB per
    block at 0) -- the exact symbol stream
    :func:`golden.run_length_encode` produces per block, computed without
    the per-block Python loop (reference huffman.py:187-194 counts by
    looping).  Categories/sizes beyond the extended range raise (they
    cannot exist for 8-bit input at any quality >= 1).
    """
    dc = np.asarray(dc).reshape(-1)
    dc_cats = bits_required(dc)
    if dc_cats.size and int(dc_cats.max()) >= DC_CATS:
        raise ValueError(
            "DC difference magnitude exceeds the dynamic-table range"
        )
    dc_counts = np.bincount(dc_cats, minlength=DC_CATS)[:DC_CATS]
    ac = np.asarray(ac).reshape(-1, 63)
    n = ac.shape[0]
    nz, run, size = ac_symbols(ac)
    if nz.any() and int(size[nz].max()) >= AC_SIZES:
        raise ValueError(
            "AC coefficient magnitude exceeds the dynamic-table range"
        )
    idx = ((run & 15) * AC_SIZES + size)[nz]
    ac_counts = np.bincount(idx, minlength=16 * AC_SIZES)[: 16 * AC_SIZES]
    # folded ZRL prefixes
    ac_counts[15 * AC_SIZES] += int((run >> 4)[nz].sum())
    ac_counts[0] += n  # unconditional EOB per block
    return dc_counts.astype(np.int64), ac_counts.astype(np.int64)


def build_huffman_spec(arrays: CodecArrays) -> HuffmanSpec:
    """Frequency-optimal tables for one image's coefficients.

    Counterpart of reference calc_huffman_table (huffman.py:101-109), but
    canonical and 16-bit-limited.
    """
    return build_huffman_spec_from_counts(
        *symbol_counts(arrays.dc, arrays.ac)
    )


def build_huffman_spec_from_counts(
    dc_counts: np.ndarray, ac_counts: np.ndarray
) -> HuffmanSpec:
    """Histograms (as from :func:`symbol_counts`) -> canonical tables.

    Frequency dicts are built in fixed index order so tie-breaking (and
    therefore the emitted table) is identical whether counts came from the
    host path or the device pipeline.
    """
    dc_freqs = {cat: int(c) for cat, c in enumerate(dc_counts) if c}
    ac_freqs = {
        (run, size): int(ac_counts[run * AC_SIZES + size])
        for run in range(16)
        for size in range(AC_SIZES)
        if ac_counts[run * AC_SIZES + size]
    }
    return spec_from_lengths(_huffman_code_lengths(dc_freqs),
                             _huffman_code_lengths(ac_freqs))


def spec_from_lengths(dc_lengths: dict, ac_lengths: dict) -> HuffmanSpec:
    """Code lengths (DC category -> length, (run, size) -> length) ->
    the canonical tables with those lengths."""
    dc_code = np.zeros(DC_CATS, dtype=np.uint32)
    dc_len = np.zeros(DC_CATS, dtype=np.int32)
    for sym, (c, l) in _canonical_codes(dc_lengths).items():
        dc_code[sym] = c
        dc_len[sym] = l
    ac_code = np.zeros((16, AC_SIZES), dtype=np.uint32)
    ac_len = np.zeros((16, AC_SIZES), dtype=np.int32)
    for (run, size), (c, l) in _canonical_codes(ac_lengths).items():
        ac_code[run, size] = c
        ac_len[run, size] = l
    return HuffmanSpec(dc_code, dc_len, ac_code, ac_len)


def block_bit_counts(dc: np.ndarray, ac: np.ndarray,
                     spec: HuffmanSpec) -> np.ndarray:
    """Bits each block takes when coded with ``spec`` (DPCM'd ``dc`` (n,),
    zig-zag ``ac`` (n, 63)): DC code + magnitude, for every nonzero AC
    coefficient its ZRL prefixes, (run, size) code and magnitude, and the
    EOB code.  Every symbol the blocks use must have a code in ``spec``."""
    dc = np.asarray(dc).reshape(-1)
    ac = np.asarray(ac).reshape(-1, 63)
    cat = bits_required(dc).astype(np.int64)
    nz, run, size = ac_symbols(ac)
    size = size.astype(np.int64)
    ac_len = spec.ac_len.astype(np.int64)
    per_coef = ((run >> 4) * ac_len[15, 0]
                + ac_len[run & 15, np.minimum(size, AC_SIZES - 1)] + size)
    return (spec.dc_len.astype(np.int64)[cat] + cat
            + np.where(nz, per_coef, 0).sum(axis=1) + ac_len[0, 0])
