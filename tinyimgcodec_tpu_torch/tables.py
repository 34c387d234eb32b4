"""The codec's state on the device: its tables.

The codec has no weights.  What a decode needs besides the stream is
:class:`DecodeTables` (below).  What an encode needs besides the pixels is

- the fused (64, 64) float32 matrix of the fast transform (DCT basis x
  reciprocal quantization divisors, columns in zig-zag order) and its DC
  offset (the folded level shift);
- the float64 8x8 DCT basis, the float64 quantization divisors and their
  reciprocals, of the exact transform (the reciprocals for its products,
  the divisors for the blocks it settles in the oracle's arithmetic);
- the Huffman symbol tables as ``code << 8 | length`` words (12 DC
  categories, 16 x 11 AC (run, size) pairs) and the 0..3-fold ZRL prefix
  left-aligned in two 32-bit words.

:meth:`CodecTables.build` makes them from this package's own
``constants``; :meth:`CodecTables.from_spec` puts in the Huffman codes of
a table built at run time (auto-table encode); :meth:`CodecTables.from_numpy`
takes them as numpy arrays from anywhere else (the tests hand over the JAX
package's arrays to show that both give the same bits).  The kernels take
every table as a tensor argument.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import constants as C
from .constants import AAN_SCALES, ZIGZAG_ORDER, quant_divisors
from .device import resolve_device
from .huffman import HuffmanSpec


@functools.cache
def dct_basis() -> np.ndarray:
    """Orthonormal 8-point DCT-II basis D (float64): coeffs = D @ x."""
    k = np.arange(8)[:, None].astype(np.float64)
    j = np.arange(8)[None, :].astype(np.float64)
    d = 0.5 * np.cos((2 * j + 1) * k * np.pi / 16.0)
    d[0, :] = 1.0 / (2.0 * math.sqrt(2.0))
    return d


@functools.cache
def fast_encode_matrix(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """Fused (64, 64) float32 matrix [pixel, zig-zag coefficient] and the
    (64,) float32 level-shift offset (nonzero in the DC column only)."""
    d = dct_basis()
    kron = np.einsum("ui,vj->ijuv", d, d).reshape(64, 64)
    recip = (1.0 / quant_divisors(quality)).reshape(64)
    m = (kron * recip[None, :])[:, ZIGZAG_ORDER]
    offset = 128.0 * m.sum(axis=0)
    offset[np.abs(offset) < 1e-6] = 0.0
    return m.astype(np.float32), offset.astype(np.float32)


def symbol_words(dc_code, dc_len, ac_code, ac_len):
    """Huffman codes and lengths -> ``(dc_comb (12,), ac_comb (176,),
    zrl_hi (4,), zrl_lo (4,))`` uint32: ``code << 8 | length`` for the 12
    DC categories and the 16 x 11 AC (run, size) pairs, and the z-fold
    prefix of the table's own ZRL code (run 15, size 0) left-aligned in
    two words for z = 0..3 (zero where the table has no ZRL code)."""
    dc_comb = (np.asarray(dc_code, np.uint64).reshape(12) << 8) | np.asarray(
        dc_len, np.uint64).reshape(12)
    ac_code = np.asarray(ac_code, np.uint64).reshape(16, 11)
    ac_len = np.asarray(ac_len, np.uint64).reshape(16, 11)
    ac_comb = (ac_code.reshape(-1) << 8) | ac_len.reshape(-1)
    zcode, zlen = int(ac_code[15, 0]), int(ac_len[15, 0])
    zrl_hi = np.zeros(4, np.uint32)
    zrl_lo = np.zeros(4, np.uint32)
    for z in range(1, 4):
        v = 0
        for _ in range(z):
            v = (v << zlen) | zcode
        v64 = v << (64 - zlen * z)
        zrl_hi[z] = v64 >> 32
        zrl_lo[z] = v64 & 0xFFFFFFFF
    return dc_comb.astype(np.uint32), ac_comb.astype(np.uint32), zrl_hi, zrl_lo


@functools.cache
def symbol_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`symbol_words` of the standard (Annex K) tables."""
    return symbol_words(C.DC_CODE, C.DC_CODELEN, C.AC_CODE, C.AC_CODELEN)


def _bits_i32(a: np.ndarray) -> np.ndarray:
    """uint32 table -> the same 32-bit patterns as int32 (torch has no
    uint32 arithmetic on the CPU; kernels reinterpret them)."""
    return np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)


@dataclasses.dataclass(frozen=True)
class CodecTables:
    """Per-quality device tensors.  32-bit table words are carried as
    int32 bit patterns."""

    encode_matrix: torch.Tensor   # (64, 64) float32 [pixel, zz coeff]
    dc_offset: float              # level-shift offset of the DC column
    dct_basis: torch.Tensor       # (8, 8) float64
    recip_divisors: torch.Tensor  # (8, 8) float64, 1 / divisor
    divisors: torch.Tensor        # (8, 8) float64 quantization divisors
    dc_comb: torch.Tensor         # (12,) int32: code << 8 | length
    ac_comb: torch.Tensor         # (176,) int32, index run * 11 + size
    zrl_hi: torch.Tensor          # (4,) int32: z-fold ZRL, bits 63..32
    zrl_lo: torch.Tensor          # (4,) int32: bits 31..0
    zigzag: torch.Tensor          # (64,) int64 row-major index per zz slot

    @property
    def device(self) -> torch.device:
        return self.encode_matrix.device

    @classmethod
    def from_numpy(cls, encode_matrix, dc_offset, dct_basis, divisors,
                   dc_comb, ac_comb, zrl_hi, zrl_lo,
                   device: str | torch.device = "cpu") -> "CodecTables":
        dev = torch.device(device)
        divisors = np.asarray(divisors, np.float64)

        def t(a, dtype):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=dtype).copy()
            ).to(dev)

        return cls(
            encode_matrix=t(encode_matrix, np.float32).reshape(64, 64),
            dc_offset=float(np.float32(dc_offset)),
            dct_basis=t(dct_basis, np.float64).reshape(8, 8),
            recip_divisors=t(1.0 / divisors, np.float64).reshape(8, 8),
            divisors=t(divisors, np.float64).reshape(8, 8),
            dc_comb=t(_bits_i32(dc_comb), np.int32),
            ac_comb=t(_bits_i32(ac_comb), np.int32),
            zrl_hi=t(_bits_i32(zrl_hi), np.int32),
            zrl_lo=t(_bits_i32(zrl_lo), np.int32),
            zigzag=t(ZIGZAG_ORDER, np.int64),
        )

    @classmethod
    def build(cls, quality: int,
              device: str | torch.device = "cpu") -> "CodecTables":
        return _build_cached(int(quality), str(resolve_device(device)))

    @classmethod
    def from_spec(cls, spec, quality: int,
                  device: str | torch.device = "cpu") -> "CodecTables":
        """The tables of ``quality`` with the Huffman codes of ``spec``, a
        run-time table: a ``huffman.HuffmanSpec`` (refused when it is
        ``extended``: the kernels' symbols stop at DC category 11 and AC
        size 10) or the four arrays of its ``device_tables()``."""
        if isinstance(spec, HuffmanSpec):
            if spec.extended:
                raise ValueError("an extended Huffman table has symbols "
                                 "outside the kernels' range")
            spec = spec.device_tables()
        return _with_symbols(int(quality), symbol_words(*spec),
                             str(resolve_device(device)))


def _with_symbols(quality: int, words: tuple, device: str) -> CodecTables:
    """The tables of ``quality`` with the symbol words ``words``
    (:func:`symbol_words`)."""
    m, off = fast_encode_matrix(quality)
    if np.any(off[1:] != 0.0):  # only the DC column has a basis sum
        raise ValueError("fast transform offset outside the DC column")
    return CodecTables.from_numpy(
        m, off[0], dct_basis(), quant_divisors(quality), *words,
        device=device,
    )


@functools.lru_cache(maxsize=64)
def _build_cached(quality: int, device: str) -> CodecTables:
    return _with_symbols(quality, symbol_tables(), device)


# ---------------------------------------------------------------- decode


def dequant_multipliers(quality: int, scaled_dct: bool = False) -> np.ndarray:
    """Per-position float64 dequantization multiplier (8, 8).

    Normal streams: the quantization divisors.  ``scaled_dct`` streams
    (from the embedded fixed-point encoder): ``quality`` holds the qfactor
    shift and the coefficients carry AAN scaling, so the multiplier is
    ``div50 * 2**qfactor / AAN``.
    """
    if scaled_dct:
        return quant_divisors(50) * float(2 ** quality) / AAN_SCALES
    return quant_divisors(quality)


def decode_matrix(multipliers: np.ndarray) -> np.ndarray:
    """Fused (64, 64) float64 matrix [zig-zag coefficient, pixel]:
    dequantize + inverse DCT, giving pixel values - 128."""
    d = dct_basis()
    kron = np.einsum("ui,vj->ijuv", d, d).reshape(64, 64)  # [pixel, coeff]
    mult = np.asarray(multipliers, np.float64).reshape(64)
    return np.ascontiguousarray((kron * mult[None, :])[:, ZIGZAG_ORDER].T)


@functools.cache
def fast_decode_matrix(quality: int, scaled_dct: bool = False) -> np.ndarray:
    """:func:`decode_matrix` of the stream's multipliers, in float32."""
    return decode_matrix(dequant_multipliers(quality, scaled_dct)).astype(
        np.float32
    )


@functools.cache
def standard_decode_tables():
    """Canonical per-length decode tables of the Annex K codes (T.81
    F.2.2.3 form), ``((mincode, maxcode, valptr, huffval) for DC, the same
    for AC)``: for each code length l in 1..16 (index 0 unused) the first
    and last code of that length (``maxcode`` -1 where the length is
    unused) and the index of its first symbol in ``huffval``."""

    def build(bits, huffval):
        mincode = np.zeros(17, np.int32)
        maxcode = np.full(17, -1, np.int32)
        valptr = np.zeros(17, np.int32)
        code = 0
        k = 0
        for l in range(1, 17):
            n = bits[l - 1]
            if n:
                valptr[l] = k
                mincode[l] = code
                maxcode[l] = code + n - 1
                code += n
                k += n
            code <<= 1
        return mincode, maxcode, valptr, np.asarray(huffval, np.int32)

    return build(C.DC_BITS, C.DC_HUFFVAL), build(C.AC_BITS, C.AC_HUFFVAL)


HUFFVAL_SLOTS = 256  # huffval is zero-padded to this many entries
CANONICAL_INTS = 3 * 17 + HUFFVAL_SLOTS  # one table of ``DecodeTables.huffman``
# Index width of the entropy decoder's first-level table.  Chosen on the
# card among 8..11 (PERF.md): the standard tables' frequent codes are
# at most 9 bits long, wider tables only cost shared memory.
LOOKUP_BITS = 10


def canonical_decode(window16: np.ndarray, table) -> tuple:
    """The decoder's length rule on 16-bit windows: ``(length, symbol)``
    arrays, the first ``l`` in 1..16 with ``window >> (16 - l) <=
    maxcode[l]`` and ``huffval[clamp(valptr[l] + code - mincode[l], 0,
    255)]``; length 0 (and symbol 0) where no code of the table matches.
    ``table``: ``(mincode, maxcode, valptr, huffval)``."""
    mincode, maxcode, valptr, huffval = (np.asarray(a, np.int64)
                                         for a in table)
    hv = np.zeros(HUFFVAL_SLOTS, np.int64)
    hv[: len(huffval)] = huffval
    w = np.asarray(window16, np.int64)
    length = np.zeros(w.shape, np.int64)
    symbol = np.zeros(w.shape, np.int64)
    for l in range(1, 17):
        code = w >> (16 - l)
        hit = (length == 0) & (code <= maxcode[l])
        idx = np.clip(valptr[l] + code - mincode[l], 0, HUFFVAL_SLOTS - 1)
        length[hit] = l
        symbol[hit] = hv[idx[hit]]
    return length, symbol


def first_level_lookup(table, bits: int = LOOKUP_BITS) -> np.ndarray:
    """(2**bits,) int32 first-level decode table: entry ``i`` answers every
    window whose leading ``bits`` bits are ``i`` with ``symbol << 8 |
    length`` when a code of at most ``bits`` bits matches, else 0 (the
    decoder then goes on with the canonical search from ``bits + 1``).
    A window's leading bits decide any match of that length, so the entry
    is :func:`canonical_decode` of ``i`` followed by zero bits, kept where
    the length fits."""
    if not 1 <= bits <= 12:
        raise ValueError(f"lookup width {bits} outside 1..12")
    window = np.arange(1 << bits, dtype=np.int64) << (16 - bits)
    length, symbol = canonical_decode(window, table)
    keep = (length >= 1) & (length <= bits)
    return np.where(keep, (symbol << 8) | length, 0).astype(np.int32)


LOOKUP_EOB = 1 << 14


def pack_lookup(entries: np.ndarray, dc: bool) -> np.ndarray:
    """:func:`first_level_lookup` entries -> the words the kernel reads,
    with everything a decode step needs already worked out: bits 0..4 the
    bits to advance (code length + value size; 0 = no code this short),
    5..8 the value's size, 9..13 the zig-zag step, bit 14 end of block.
    DC table: size = min(symbol, 15), step 0.  AC table: size = symbol &
    15, step = run + 1 (16 with size 0 for ZRL); symbol 0 is EOB (size 0,
    step 0).  The kernel's ``pack_entry`` does the same for the codes the
    table leaves to the canonical search."""
    e = np.asarray(entries, np.int64)
    length, sym = e & 0xFF, e >> 8
    if dc:
        size = np.minimum(sym, 15)
        packed = (length + size) | (size << 5)
    else:
        size = sym & 15
        step = ((sym >> 4) & 15) + 1
        packed = np.where(sym == 0, length | LOOKUP_EOB,
                          (length + size) | (size << 5) | (step << 9))
    return np.where(length > 0, packed, 0).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class DecodeTables:
    """What a decode needs on the device.

    ``huffman``: (2, 307) int32, for DC then AC ``[mincode (17), maxcode
    (17), valptr (17), huffval (256, zero-padded)]`` -- the entropy decode
    kernel's table argument, the same layout for the standard tables and
    for a stream's own.  ``fast_matrix`` / ``exact_matrix``: the fused
    dequantize + inverse-DCT matrix [zig-zag coefficient, pixel] in
    float32 and float64.  ``lookup``: (2, 2**bits) int32, the first-level
    table of :func:`first_level_lookup` for DC then AC in the packed form
    of :func:`pack_lookup`, derived from ``huffman`` once per batch so
    that the kernel answers most symbols with one shared-memory read.
    """

    huffman: torch.Tensor
    fast_matrix: torch.Tensor
    exact_matrix: torch.Tensor
    lookup: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.huffman.device

    @classmethod
    def from_numpy(cls, dc_table, ac_table, fast_matrix, multipliers,
                   device: str | torch.device = "cpu",
                   lookup_bits: int = LOOKUP_BITS) -> "DecodeTables":
        """``dc_table`` / ``ac_table``: ``(mincode, maxcode, valptr,
        huffval)`` tuples as :func:`standard_decode_tables` or
        ``ops.entropy_decode.canonical_tables`` return them;
        ``fast_matrix`` (64, 64) float32; ``multipliers`` (8, 8) float64
        (:func:`dequant_multipliers`).  Symbols are bytes: a ``huffval``
        outside 0..255 is refused."""
        dev = torch.device(device)
        rows = []
        for mincode, maxcode, valptr, huffval in (dc_table, ac_table):
            hv = np.zeros(HUFFVAL_SLOTS, np.int32)
            hv[: len(huffval)] = np.asarray(huffval, np.int32)
            if hv.min() < 0 or hv.max() > 255:
                raise ValueError("huffval entries must lie in 0..255")
            rows.append(np.concatenate([
                np.asarray(mincode, np.int32), np.asarray(maxcode, np.int32),
                np.asarray(valptr, np.int32), hv,
            ]))
        packed = np.stack(rows)
        if packed.shape != (2, CANONICAL_INTS):
            raise ValueError(f"decode tables of shape {packed.shape}")
        lookup = np.stack([
            pack_lookup(first_level_lookup(t, lookup_bits), dc)
            for t, dc in ((dc_table, True), (ac_table, False))])
        return cls(
            huffman=torch.from_numpy(packed).to(dev),
            lookup=torch.from_numpy(lookup).to(dev),
            fast_matrix=torch.from_numpy(
                np.ascontiguousarray(fast_matrix, np.float32).copy()
            ).reshape(64, 64).to(dev),
            exact_matrix=torch.from_numpy(decode_matrix(multipliers)).to(dev),
        )

    @classmethod
    def build(cls, quality: int, scaled_dct: bool = False,
              device: str | torch.device = "cpu",
              huffman=None) -> "DecodeTables":
        """Tables of a stream with this header.  ``huffman``: the
        stream's own canonical ``(dc_table, ac_table)``; ``None`` = the
        standard Annex K tables (cached per quality and device)."""
        if huffman is None:
            return _build_decode_cached(
                int(quality), bool(scaled_dct), str(resolve_device(device))
            )
        return cls.from_numpy(
            *huffman, fast_decode_matrix(int(quality), bool(scaled_dct)),
            dequant_multipliers(int(quality), bool(scaled_dct)), device=device,
        )


@functools.lru_cache(maxsize=64)
def _build_decode_cached(quality: int, scaled_dct: bool,
                         device: str) -> DecodeTables:
    return DecodeTables.build(
        quality, scaled_dct, device, huffman=standard_decode_tables()
    )
