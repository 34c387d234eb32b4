"""Static tables for the grayscale JPEG-style codec (PyTorch/CUDA port).

All tables here are standard JPEG (ITU-T T.81 Annex K) constants, stored in
*gather-friendly numeric layouts* so device kernels can look codes up with a
single vectorized gather instead of dict lookups.

Parity notes (reference: tinyimgcodec/constants.py):
- ``LUMINANCE_QUANTIZATION_TABLE`` matches ``constants.py:9-20`` (Annex K luma).
- ``ZIGZAG_ORDER`` matches ``constants.py:23-34``.
- ``AAN_SCALES`` matches ``ANNSCALES`` (``constants.py:37-51``): the outer
  product of the AAN 1-D scale factors x 8, in Q11 fixed point / 2048.
- The Huffman code tables are derived canonically from the Annex K
  BITS/HUFFVAL spec arrays; the resulting codewords are verified by tests to
  be identical to the reference's string table (``constants.py:54-241``).
"""

from __future__ import annotations

import math

import numpy as np

# Symbolic markers (match reference constants.py:4-7 semantics).
EOB = (0, 0)   # end-of-block (run=0, size=0)
ZRL = (15, 0)  # zero-run-length: 16 zeros (run=15, size=0)
DC = "DC"
AC = "AC"

# Standard JPEG Annex K luminance quantization table (row-major 8x8).
LUMINANCE_QUANTIZATION_TABLE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.int32,
)

# Zig-zag scan: ZIGZAG_ORDER[k] = row-major index of the k-th coefficient in
# zig-zag order (a gather permutation, same convention as the reference).
ZIGZAG_ORDER = np.array(
    # fmt: off
    [
        0, 1, 8, 16, 9, 2, 3, 10,
        17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ],
    # fmt: on
    dtype=np.int32,
)

# Inverse permutation: INVERSE_ZIGZAG[row_major_index] = zigzag position.
INVERSE_ZIGZAG = np.argsort(ZIGZAG_ORDER).astype(np.int32)


def _aan_scales() -> np.ndarray:
    """AAN fixed-point DCT output scales.

    The AAN fast-DCT 1-D output k is scaled by 8*s[k] relative to the
    orthonormal DCT, with s[k] = cos(k*pi/16)/2 and s[0] = 1/(2*sqrt(2)).
    The table is the 2-D outer product round(64 * s_i * s_j * 2048) / 2048,
    matching reference ANNSCALES (constants.py:37-51) exactly; the embedded
    fixed-point encoder's output (c/img.c:47-125) is descaled by it at
    decode (codec.py:59-62).
    """
    s = np.array(
        [1.0 / (2.0 * math.sqrt(2.0))]
        + [math.cos(k * math.pi / 16.0) / 2.0 for k in range(1, 8)]
    )
    q11 = np.round(np.outer(8.0 * s, 8.0 * s) * 2048.0)
    return q11 / 2048.0


AAN_SCALES = _aan_scales()

# ---------------------------------------------------------------------------
# Canonical Huffman tables (Annex K.3.3.1 / K.3.3.2, luminance).
#
# Derived from the BITS (number of codes of each length 1..16) and HUFFVAL
# (symbol values in code order) spec arrays, exactly as T.81 Annex C defines
# canonical code generation.  This reproduces the reference's hand-written
# string table (constants.py:54-241) -- tests assert equality.
# ---------------------------------------------------------------------------

# Luminance DC: symbols are categories 0..11.
DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_HUFFVAL = list(range(12))

# Luminance AC: symbols are (run << 4 | size); 0x00 = EOB, 0xF0 = ZRL.
AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
AC_HUFFVAL = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
]


def canonical_codes(bits: list[int], huffval: list[int]) -> dict[int, tuple[int, int]]:
    """Generate canonical Huffman codes: symbol -> (code, length)."""
    out: dict[int, tuple[int, int]] = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[huffval[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _build_dc_tables() -> tuple[np.ndarray, np.ndarray]:
    codes = canonical_codes(DC_BITS, DC_HUFFVAL)
    code_arr = np.zeros(12, dtype=np.uint32)
    len_arr = np.zeros(12, dtype=np.int32)
    for sym, (c, l) in codes.items():
        code_arr[sym] = c
        len_arr[sym] = l
    return code_arr, len_arr


def _build_ac_tables() -> tuple[np.ndarray, np.ndarray]:
    codes = canonical_codes(AC_BITS, AC_HUFFVAL)
    code_arr = np.zeros((16, 11), dtype=np.uint32)
    len_arr = np.zeros((16, 11), dtype=np.int32)
    for sym, (c, l) in codes.items():
        run, size = sym >> 4, sym & 0xF
        code_arr[run, size] = c
        len_arr[run, size] = l
    return code_arr, len_arr


# DC_CODE[cat], DC_CODELEN[cat] for categories 0..11.
DC_CODE, DC_CODELEN = _build_dc_tables()
# AC_CODE[run][size], AC_CODELEN[run][size]; [0][0]=EOB, [15][0]=ZRL,
# other size==0 entries are invalid (length 0).
AC_CODE, AC_CODELEN = _build_ac_tables()

EOB_CODE = int(AC_CODE[0, 0])
EOB_LEN = int(AC_CODELEN[0, 0])    # 4  ("1010")
ZRL_CODE = int(AC_CODE[15, 0])
ZRL_LEN = int(AC_CODELEN[15, 0])   # 11 ("11111111001")

# Maximum payload bits a single encoded coefficient slot can produce:
# 3 x ZRL (run up to 62 zeros -> <= 3 ZRLs) + 16-bit AC code + 10 magnitude
# bits = 59 bits; the DC slot needs <= 9 + 11 = 20 bits; EOB needs 4.
MAX_SLOT_BITS = 3 * ZRL_LEN + 16 + 10
assert MAX_SLOT_BITS <= 64

# Upper bound on one block's payload bits: 63 AC coefficients at <= 26 bits
# (runs only cheapen this: ZRL is 11 bits and absorbs >= 16 coefficient
# slots) + 20 DC bits + 4 EOB bits = 1662 bits -> 52 u32 words.
MAX_BLOCK_BITS = 63 * 26 + 20 + EOB_LEN
BLOCK_WORDS = (MAX_BLOCK_BITS + 31) // 32
assert BLOCK_WORDS == 52


def string_code_tables() -> dict[str, dict]:
    """Bit-string view of the tables (reference constants.py:54-241 format).

    DC maps category -> "0"/"1" string; AC maps (run, size) -> string.
    Used by the host/golden paths and conformance tests.
    """
    dc = {
        cat: format(int(DC_CODE[cat]), "0{}b".format(int(DC_CODELEN[cat])))
        for cat in range(12)
    }
    ac = {}
    for run in range(16):
        for size in range(11):
            l = int(AC_CODELEN[run, size])
            if l:
                ac[(run, size)] = format(int(AC_CODE[run, size]), "0{}b".format(l))
    return {DC: dc, AC: ac}


def quality_to_factor(quality: int) -> float:
    """IJG-style quality->scale mapping (reference utils.py:50).

    Valid range is effectively 1..99: quality=100 would make the factor 0
    (divide-by-zero; the reference NaNs there too, SURVEY quirk 2.5-6).
    """
    return 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality


def quant_divisors(quality: int) -> np.ndarray:
    """Per-coefficient quantization divisors (float64 8x8)."""
    return LUMINANCE_QUANTIZATION_TABLE * quality_to_factor(quality) / 100.0


# Container header flags (16-byte header: height,width,quality,flag u32 LE).
# Bit 31: embedded custom Huffman table follows the header.
# Bit 30: "scaled DCT" stream produced by the embedded fixed-point encoder
#         (reference c/img.c:183-192); quality field holds the shift 0..3.
FLAG_CUSTOM_TABLE = 1 << 31
FLAG_SCALED_DCT = 1 << 30
HEADER_BYTES = 16
