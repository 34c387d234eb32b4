"""The codec's constant tables, for the plain reference.

A frozen copy of the tables the reference needs from
``tinyimgcodec_tpu_torch/constants.py`` at commit ``2360460`` (Annex K
luminance quantization table, zig-zag order, the luminance Huffman
BITS/HUFFVAL arrays and their canonical codes, the quality mapping, the
header and TICX trailer constants).  Nothing here is imported from the
program, so a change to the program's tables cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np

HEADER_BYTES = 16
INDEX_MAGIC = b"TICX"

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

# ZIGZAG_ORDER[k] = row-major index of the k-th coefficient in zig-zag order
ZIGZAG_ORDER = np.array(
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
    dtype=np.int64,
)
INVERSE_ZIGZAG = np.argsort(ZIGZAG_ORDER)

DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_HUFFVAL = list(range(12))
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


def canonical_codes(bits: list[int], huffval: list[int]):
    """T.81 Annex C canonical codes: symbol -> (code, length)."""
    out = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[huffval[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _dc_tables():
    code = np.zeros(12, np.int64)
    length = np.zeros(12, np.int64)
    for sym, (c, n) in canonical_codes(DC_BITS, DC_HUFFVAL).items():
        code[sym], length[sym] = c, n
    return code, length


def _ac_tables():
    """(16, 16) tables by (run, size); length 0 = no such symbol."""
    code = np.zeros((16, 16), np.int64)
    length = np.zeros((16, 16), np.int64)
    for sym, (c, n) in canonical_codes(AC_BITS, AC_HUFFVAL).items():
        code[sym >> 4, sym & 0xF], length[sym >> 4, sym & 0xF] = c, n
    return code, length


DC_CODE, DC_LEN = _dc_tables()
AC_CODE, AC_LEN = _ac_tables()


def quant_divisors(quality: int) -> np.ndarray:
    """Per-coefficient float64 divisors (IJG quality mapping)."""
    factor = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    return LUMINANCE_QUANTIZATION_TABLE * factor / 100.0
