"""The plain reference of the codec's fast precision: PyTorch float32 on
the CPU, nothing of the program.

Fast mode's bytes are defined by the float32 arithmetic of the encode
kernel, written here from the format's definition:

- the fused (64, 64) matrix [pixel, zig-zag coefficient]: the orthonormal
  8x8 DCT basis, its Kronecker product over (row, column), times the
  reciprocals of the quality's divisors, columns in zig-zag order, cast to
  float32; the DC offset is 128 times the float64 sum of column 0 (the
  folded level shift), cast to float32;
- each block reflect-padded to multiples of 8, its pixels as float32, and
  for each coefficient k: ``acc = x[0] * M[0, k]``, then
  ``acc = acc + x[q] * M[q, k]`` for q = 1..63 in ascending order, every
  product and every sum rounded to float32 on its own (elementwise
  ``torch.mul`` and ``torch.add``; no matrix product, no fused operation);
  ``acc - offset`` in float32 for k = 0; round half to even;
- the entropy coding, packing, header and TICX trailer of the exact
  reference (``portbench/reference/codec.py``), unchanged.

A CPU test holds the matrix and offset to the program's bit for bit and
the streams to the program's fast ``compress_batch`` byte for byte.
"""

from __future__ import annotations

import contextlib
import math
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench.reference import codec
from portbench.reference.tables import ZIGZAG_ORDER, quant_divisors

SLICE_BLOCKS = 1024  # blocks a slice: their products take 16 MiB


@contextlib.contextmanager
def _no_tf32():
    """float32 matrix arithmetic at full precision while the block runs
    (no TF32 anywhere), the process's settings restored after."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def matrix(quality: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused (64, 64) float32 matrix [pixel, zig-zag coefficient] and
    the float32 DC offset of ``quality``."""
    k = torch.arange(8, dtype=torch.float64)[:, None]
    j = torch.arange(8, dtype=torch.float64)[None, :]
    d = 0.5 * torch.cos((2 * j + 1) * k * math.pi / 16.0)
    d[0, :] = 1.0 / (2.0 * math.sqrt(2.0))  # d[u, i]: basis u at pixel i
    # [(i, j) pixel, (u, v) frequency] = d[u, i] * d[v, j]
    kron = torch.einsum("ui,vj->ijuv", d, d).reshape(64, 64)
    recip = 1.0 / torch.from_numpy(
        np.asarray(quant_divisors(quality), np.float64)).reshape(64)
    m = (kron * recip[None, :])[:, torch.from_numpy(ZIGZAG_ORDER)]
    offset = 128.0 * m[:, 0].sum()
    return m.to(torch.float32), offset.to(torch.float32)


def _padded_blocks(images: np.ndarray) -> torch.Tensor:
    """(B, H, W) uint8 -> (B * nblocks, 64) float32 pixels of the reflect
    padded blocks, raster order within each image."""
    b, h, w = images.shape
    ph, pw = -h % 8, -w % 8
    if ph or pw:
        images = np.pad(images, ((0, 0), (0, ph), (0, pw)), mode="reflect")
    x = torch.from_numpy(np.ascontiguousarray(images)).to(torch.float32)
    h8, w8 = h + ph, w + pw
    x = x.reshape(b, h8 // 8, 8, w8 // 8, 8).transpose(2, 3)
    return x.reshape(-1, 64)


def coefficients(images: np.ndarray, quality: int) -> np.ndarray:
    """(B, H, W) uint8 -> (B, nblocks, 64) int32 quantized zig-zag
    coefficients, summed in ascending pixel order in float32."""
    images = np.asarray(images)
    m, offset = matrix(quality)
    x = _padded_blocks(images)
    out = torch.empty((x.shape[0], 64), dtype=torch.int32)
    for s in range(0, x.shape[0], SLICE_BLOCKS):
        xs = x[s:s + SLICE_BLOCKS]
        prod = torch.mul(xs[:, :, None], m)  # [block, pixel, coefficient]
        acc = prod[:, 0].clone()
        for q in range(1, 64):
            acc = torch.add(acc, prod[:, q])
        acc[:, 0] = torch.sub(acc[:, 0], offset)
        out[s:s + SLICE_BLOCKS] = torch.round(acc).to(torch.int32)
    return out.numpy().reshape(images.shape[0], -1, 64)


def encode(images: np.ndarray, quality: int, index_stride: int = 64):
    """(B, H, W) uint8 -> (one TICX-indexed stream an image, the (B,
    nblocks, 64) int32 coefficients they code), as ``codec.encode`` with
    the fast coefficients."""
    images = np.asarray(images)
    b, h, w = images.shape
    if index_stride & (index_stride - 1):
        raise ValueError("index stride must be a power of two")
    per = max(1, codec._GROUP_PIXELS // (h * w))
    streams: list[bytes] = []
    coeffs = []
    header = struct.pack("<IIII", h, w, quality, 0)
    with _no_tf32():
        for g in range(0, b, per):
            zz = coefficients(images[g:g + per], quality)
            coeffs.append(zz)
            n_img, nb = zz.shape[:2]
            dpcm = zz.reshape(-1, 64).copy()
            d = dpcm[:, 0].reshape(n_img, nb)
            d[:, 1:] = np.diff(zz[:, :, 0], axis=1)
            dpcm[:, 0] = d.reshape(-1)
            values, lengths, block_tok = codec._tokens(dpcm)
            image_of = np.repeat(np.arange(n_img), np.diff(np.append(
                block_tok[::nb], len(lengths))))
            payloads, within = codec._pack(values, lengths, image_of, n_img)
            offsets = within[block_tok].reshape(n_img, nb)
            streams += [header + payloads[i]
                        + codec._trailer(offsets[i], index_stride)
                        for i in range(n_img)]
    return streams, np.concatenate(coeffs)


def encode_pool(pool, quality: int, index_stride: int = 64):
    """:func:`encode` of each input of ``pool`` (a list of (B, H, W)
    arrays), in pieces of ``codec.POOL_IMAGES`` images on
    ``codec.POOL_THREADS`` threads: a (streams, coefficients) pair an
    input, as ``codec.encode_pool`` gives them."""
    per = codec.POOL_IMAGES
    pieces = [(k, i) for k, x in enumerate(pool)
              for i in range(0, len(x), per)]

    def enc(piece):
        k, i = piece
        return encode(pool[k][i:i + per], quality, index_stride)

    # set once around the threads, so that their own settings nest
    with _no_tf32(), ThreadPoolExecutor(
            min(len(pieces), codec.POOL_THREADS)) as ex:
        done = list(ex.map(enc, pieces))
    out = []
    for k in range(len(pool)):
        mine = [d for (kk, _), d in zip(pieces, done) if kk == k]
        out.append(([s for streams, _ in mine for s in streams],
                    np.concatenate([c for _, c in mine])))
    return out
