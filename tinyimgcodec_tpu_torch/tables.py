"""The codec's state on the device: its tables.

The codec has no weights.  What an encode needs besides the pixels is

- the fused (64, 64) float32 matrix of the fast transform (DCT basis x
  reciprocal quantization divisors, columns in zig-zag order) and its DC
  offset (the folded level shift);
- the float64 8x8 DCT basis and the float64 reciprocal divisors of the
  exact transform;
- the Huffman symbol tables as ``code << 8 | length`` words (12 DC
  categories, 16 x 11 AC (run, size) pairs) and the 0..3-fold ZRL prefix
  left-aligned in two 32-bit words.

:meth:`CodecTables.build` makes them from this package's own
``constants``; :meth:`CodecTables.from_numpy` takes them as numpy arrays
from anywhere else (the tests hand over the JAX package's arrays to show
that both give the same bits).  The kernels take every table as a tensor
argument, so a later slice can pass tables built at run time.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import constants as C
from .constants import ZIGZAG_ORDER, quant_divisors


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


@functools.cache
def symbol_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(dc_comb (12,), ac_comb (176,), zrl_hi (4,), zrl_lo (4,)) uint32."""
    dc_comb = (C.DC_CODE.astype(np.uint64) << 8) | C.DC_CODELEN.astype(
        np.uint64
    )
    ac_comb = (
        C.AC_CODE.reshape(-1).astype(np.uint64) << 8
    ) | C.AC_CODELEN.reshape(-1).astype(np.uint64)
    zrl_hi = np.zeros(4, np.uint32)
    zrl_lo = np.zeros(4, np.uint32)
    for z in range(1, 4):
        v = 0
        for _ in range(z):
            v = (v << C.ZRL_LEN) | C.ZRL_CODE
        v64 = v << (64 - C.ZRL_LEN * z)
        zrl_hi[z] = v64 >> 32
        zrl_lo[z] = v64 & 0xFFFFFFFF
    return dc_comb.astype(np.uint32), ac_comb.astype(np.uint32), zrl_hi, zrl_lo


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
    dc_comb: torch.Tensor         # (12,) int32: code << 8 | length
    ac_comb: torch.Tensor         # (176,) int32, index run * 11 + size
    zrl_hi: torch.Tensor          # (4,) int32: z-fold ZRL, bits 63..32
    zrl_lo: torch.Tensor          # (4,) int32: bits 31..0
    zigzag: torch.Tensor          # (64,) int64 row-major index per zz slot

    @property
    def device(self) -> torch.device:
        return self.encode_matrix.device

    @classmethod
    def from_numpy(cls, encode_matrix, dc_offset, dct_basis, recip_divisors,
                   dc_comb, ac_comb, zrl_hi, zrl_lo,
                   device: str | torch.device = "cpu") -> "CodecTables":
        dev = torch.device(device)

        def t(a, dtype):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=dtype).copy()
            ).to(dev)

        return cls(
            encode_matrix=t(encode_matrix, np.float32).reshape(64, 64),
            dc_offset=float(np.float32(dc_offset)),
            dct_basis=t(dct_basis, np.float64).reshape(8, 8),
            recip_divisors=t(recip_divisors, np.float64).reshape(8, 8),
            dc_comb=t(_bits_i32(dc_comb), np.int32),
            ac_comb=t(_bits_i32(ac_comb), np.int32),
            zrl_hi=t(_bits_i32(zrl_hi), np.int32),
            zrl_lo=t(_bits_i32(zrl_lo), np.int32),
            zigzag=t(ZIGZAG_ORDER, np.int64),
        )

    @classmethod
    def build(cls, quality: int,
              device: str | torch.device = "cpu") -> "CodecTables":
        return _build_cached(int(quality), str(torch.device(device)))


@functools.lru_cache(maxsize=64)
def _build_cached(quality: int, device: str) -> CodecTables:
    m, off = fast_encode_matrix(quality)
    if np.any(off[1:] != 0.0):  # only the DC column has a basis sum
        raise ValueError("fast transform offset outside the DC column")
    dc_comb, ac_comb, zrl_hi, zrl_lo = symbol_tables()
    return CodecTables.from_numpy(
        m, off[0], dct_basis(), 1.0 / quant_divisors(quality),
        dc_comb, ac_comb, zrl_hi, zrl_lo, device=device,
    )
