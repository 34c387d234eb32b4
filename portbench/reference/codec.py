"""The plain reference of the codec: NumPy and SciPy, nothing of the program.

What the program's exact mode must give, written from the format's
definition and vectorized over every block of a batch:

- forward: reflect-pad to multiples of 8, subtract 128, the orthonormal
  float64 8x8 DCT (``scipy.fftpack.dct``, rows then columns), divide by the
  quality's divisors, round half to even, zig-zag;
- entropy code: DC DPCM in raster order, reset at each image; each block is
  the DC category code and magnitude, then per nonzero AC coefficient 16-zero
  runs as ZRL, the (run, size) code and the magnitude (one's complement for
  negatives), then EOB always; standard Annex K luminance tables;
- stream: a 16-byte little-endian header ``height, width, quality, 0``, the
  big-endian packed payload zero-padded to a byte, then the TICX trailer of
  every ``stride``-th block's payload bit offset;
- inverse: dequantize, the orthonormal float64 inverse DCT, add 128, clip to
  0..255, truncate to uint8, crop to the true size.

A CPU test holds :func:`encode` byte for byte, and :func:`decode_pixels`
pixel for pixel, to the port's float64 host oracle (``container.compress``
with ``block_index=True`` and ``container.decompress``).
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from scipy.fftpack import dct, idct

from .tables import (
    AC_CODE,
    AC_LEN,
    DC_CODE,
    DC_LEN,
    INDEX_MAGIC,
    INVERSE_ZIGZAG,
    ZIGZAG_ORDER,
    quant_divisors,
)

ZRL_CODE, ZRL_LEN = int(AC_CODE[15, 0]), int(AC_LEN[15, 0])
EOB_CODE, EOB_LEN = int(AC_CODE[0, 0]), int(AC_LEN[0, 0])

# images are coded in groups of about this many pixels, to bound the
# memory of the bit arrays
_GROUP_PIXELS = 1 << 24
POOL_IMAGES = 8  # images a piece of encode_pool's work
POOL_THREADS = min(8, os.cpu_count() or 1)


def _blocks(images: np.ndarray) -> np.ndarray:
    """(B, H, W) uint8 -> (B, H8/8, W8/8, 8, 8) int32 less 128, reflect
    padded to multiples of 8."""
    b, h, w = images.shape
    ph, pw = -h % 8, -w % 8
    if ph or pw:
        images = np.pad(images, ((0, 0), (0, ph), (0, pw)), mode="reflect")
    h8, w8 = h + ph, w + pw
    x = images.astype(np.int32) - 128
    return x.reshape(b, h8 // 8, 8, w8 // 8, 8).swapaxes(2, 3)


def quantized(images: np.ndarray, quality: int) -> np.ndarray:
    """(B, H, W) uint8 -> (B, nblocks, 64) int32 quantized coefficients in
    zig-zag order, blocks in raster order."""
    blocks = _blocks(np.asarray(images))
    coeffs = dct(dct(blocks, norm="ortho", axis=-2), norm="ortho", axis=-1)
    q = np.round(coeffs / quant_divisors(quality)).astype(np.int32)
    b = q.shape[0]
    return q.reshape(b, -1, 64)[:, :, ZIGZAG_ORDER]


def _size(x: np.ndarray) -> np.ndarray:
    """JPEG category: the bit length of |x|."""
    a = np.abs(x.astype(np.int64))
    n = np.zeros(a.shape, np.int64)
    while True:
        nz = a > 0
        if not nz.any():
            return n
        n += nz
        a >>= 1


def _magnitude(x: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The magnitude bits: x, or its one's complement in ``size`` bits."""
    x = x.astype(np.int64)
    return np.where(x < 0, x + (np.int64(1) << size) - 1, x)


def _tokens(zz: np.ndarray):
    """(N, 64) zig-zag blocks of one image or several, DC already DPCM'd ->
    (values, lengths, first token of each block): every code and magnitude
    of the payload in stream order."""
    n = zz.shape[0]
    dc = zz[:, 0].astype(np.int64)
    ac = zz[:, 1:]
    nz_b, nz_i = np.nonzero(ac)
    vals = ac[nz_b, nz_i].astype(np.int64)
    first = np.ones(nz_b.shape, bool)
    first[1:] = nz_b[1:] != nz_b[:-1]
    prev = np.empty(nz_i.shape, np.int64)
    prev[first] = -1
    prev[~first] = nz_i[:-1][~first[1:]]
    run = nz_i - prev - 1
    zrl, run = run >> 4, run & 15
    size = _size(vals)
    if np.any(size > 10):
        raise ValueError("AC coefficient beyond the standard table range")
    t_nz = zrl + 2  # ZRLs, the code, the magnitude
    ac_tokens = np.bincount(nz_b, weights=t_nz, minlength=n).astype(np.int64)
    start = np.zeros(n + 1, np.int64)
    np.cumsum(ac_tokens + 3, out=start[1:])  # with DC code, magnitude, EOB
    total = int(start[-1])
    values = np.zeros(total, np.int64)
    lengths = np.zeros(total, np.int64)

    dsize = _size(dc)
    if np.any(dsize > 11):
        raise ValueError("DC difference beyond the standard table range")
    s = start[:-1]
    values[s], lengths[s] = DC_CODE[dsize], DC_LEN[dsize]
    values[s + 1], lengths[s + 1] = _magnitude(dc, dsize), dsize

    # each nonzero's first token: after its block's DC pair and the tokens
    # of the nonzeros before it in the block
    excl = np.zeros(t_nz.shape, np.int64)
    if len(t_nz):
        np.cumsum(t_nz[:-1], out=excl[1:])
    block_base = np.zeros(n, np.int64)
    np.cumsum(ac_tokens[:-1], out=block_base[1:])
    at = s[nz_b] + 2 + excl - block_base[nz_b]
    zrl_at = np.repeat(at, zrl) + (np.arange(int(zrl.sum()))
                                   - np.repeat(np.cumsum(zrl) - zrl, zrl))
    values[zrl_at], lengths[zrl_at] = ZRL_CODE, ZRL_LEN
    code_at = at + zrl
    values[code_at], lengths[code_at] = AC_CODE[run, size], AC_LEN[run, size]
    values[code_at + 1], lengths[code_at + 1] = _magnitude(vals, size), size
    eob = start[1:] - 1
    values[eob], lengths[eob] = EOB_CODE, EOB_LEN
    return values, lengths, s


def _pack(values: np.ndarray, lengths: np.ndarray, image_of: np.ndarray,
          n_images: int):
    """Tokens of several images -> (payload bytes of each image, each
    token's bit offset within its image's payload)."""
    pos = np.zeros(len(lengths), np.int64)
    if len(lengths):
        np.cumsum(lengths[:-1], out=pos[1:])
    ends = np.bincount(image_of, weights=lengths, minlength=n_images).astype(
        np.int64)
    img_bit0 = np.zeros(n_images, np.int64)
    np.cumsum(ends[:-1], out=img_bit0[1:])
    within = pos - img_bit0[image_of]
    nbytes = (ends + 7) // 8
    byte0 = np.zeros(n_images + 1, np.int64)
    np.cumsum(nbytes, out=byte0[1:])
    at = byte0[:-1][image_of] * 8 + within  # byte-aligned image starts
    keep = lengths > 0
    v, ln, at = values[keep], lengths[keep], at[keep]
    nbits = int(ln.sum())
    tok = np.repeat(np.arange(len(ln)), ln)
    k = np.arange(nbits) - np.repeat(np.cumsum(ln) - ln, ln)
    bits = np.zeros(int(byte0[-1]) * 8, np.uint8)
    bits[at[tok] + k] = (v[tok] >> (ln[tok] - 1 - k)) & 1
    packed = np.packbits(bits).tobytes()
    payloads = [packed[byte0[i]:byte0[i + 1]] for i in range(n_images)]
    return payloads, within


def _trailer(offsets: np.ndarray, stride: int) -> bytes:
    sel = np.ascontiguousarray(offsets[::stride], dtype="<u4")
    body = struct.pack("<BBHI", 1, stride.bit_length() - 1, 0,
                       len(sel)) + sel.tobytes()
    return body + struct.pack("<I", len(body)) + INDEX_MAGIC


def encode(images: np.ndarray, quality: int, index_stride: int = 64):
    """(B, H, W) uint8 -> (one TICX-indexed stream an image, the (B,
    nblocks, 64) int32 zig-zag coefficients they code)."""
    images = np.asarray(images)
    b, h, w = images.shape
    if index_stride & (index_stride - 1):
        raise ValueError("index stride must be a power of two")
    per = max(1, _GROUP_PIXELS // (h * w))
    streams: list[bytes] = []
    coeffs = []
    header = struct.pack("<IIII", h, w, quality, 0)
    for g in range(0, b, per):
        zz = quantized(images[g:g + per], quality)
        coeffs.append(zz)
        n_img, nb = zz.shape[:2]
        dpcm = zz.reshape(-1, 64).copy()
        d = dpcm[:, 0].reshape(n_img, nb)
        d[:, 1:] = np.diff(zz[:, :, 0], axis=1)
        dpcm[:, 0] = d.reshape(-1)
        values, lengths, block_tok = _tokens(dpcm)
        image_of = np.repeat(np.arange(n_img), np.diff(np.append(
            block_tok[::nb], len(lengths))))
        payloads, within = _pack(values, lengths, image_of, n_img)
        offsets = within[block_tok].reshape(n_img, nb)
        for i in range(n_img):
            streams.append(header + payloads[i]
                           + _trailer(offsets[i], index_stride))
    return streams, np.concatenate(coeffs)


def decode_pixels(coeffs: np.ndarray, height: int, width: int,
                  quality: int) -> np.ndarray:
    """(B, nblocks, 64) int32 zig-zag coefficients -> (B, height, width)
    uint8 pixels."""
    b = coeffs.shape[0]
    bh, bw = -(-height // 8), -(-width // 8)
    c = coeffs[:, :, INVERSE_ZIGZAG].astype(np.float64)
    c = c.reshape(b, bh, bw, 8, 8) * quant_divisors(quality)
    x = idct(idct(c, norm="ortho", axis=-2), norm="ortho", axis=-1)
    x = x.swapaxes(2, 3).reshape(b, bh * 8, bw * 8)
    x = np.clip(x + 128.0, 0.0, 255.0)
    return x[:, :height, :width].astype(np.uint8)


def encode_pool(pool, quality: int, index_stride: int = 64):
    """:func:`encode` of each input of ``pool`` (a list of (B, H, W)
    arrays), in pieces of a few images on a thread each: a (streams,
    coefficients) pair an input."""
    pieces = [(k, i) for k, x in enumerate(pool)
              for i in range(0, len(x), POOL_IMAGES)]

    def enc(piece):
        k, i = piece
        return encode(pool[k][i:i + POOL_IMAGES], quality, index_stride)

    with ThreadPoolExecutor(min(len(pieces), POOL_THREADS)) as ex:
        done = list(ex.map(enc, pieces))
    out = []
    for k in range(len(pool)):
        mine = [d for (kk, _), d in zip(pieces, done) if kk == k]
        out.append(([s for streams, _ in mine for s in streams],
                    np.concatenate([c for _, c in mine])))
    return out
