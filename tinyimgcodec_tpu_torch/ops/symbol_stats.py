"""Symbol statistics of one image, for tables built for it: kernel wrapper
and plain version.

The (64, n) int32 coefficient-major coefficients of each block range of
one image (``pipeline.range_coefficients``; a later range's first DC is
taken against the previous range's last, as ``encode_ranges`` carries
it) -> :class:`SymbolStats`: the DC and AC symbol histograms of
``huffman.symbol_counts`` (the DC by category of its DPCM difference; the
AC at ``(run & 15) * AC_SIZES + size``, the folded ZRL prefixes at
``15 * AC_SIZES``, one EOB a block at 0), the largest DC category and AC
size, and two per-block maxima: the most symbols one block codes (its DC,
nonzero AC, ZRLs and EOB) and the most magnitude bits one block carries
(DC category plus AC sizes).  With codes of at most ``L`` bits no block
takes more than ``max_symbols * L + max_magnitude_bits`` bits
(:meth:`SymbolStats.block_bits_bound`).

It replaces no TPU kernel: the JAX package counts on the host, in numpy,
after pulling the coefficients (``tinyimgcodec_tpu/engine.py:423``).  On
the card: ``csrc/symbol_stats.cu``, one launch a range into one int64
buffer, pulled once; launch- and latency-bound (1 MB read a 512x512
image).  The plain version computes the same buffer with tensor
operations; it serves CPU tensors and is the kernel's yardstick of
correctness, not of speed.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..huffman import AC_SIZES, DC_CATS
from . import _build

AC0 = DC_CATS                   # the AC histogram's first word
HIST = DC_CATS + 16 * AC_SIZES  # words of the two histograms
# the four maxima after them: DC category, AC size, symbols a block,
# magnitude bits a block
MAX_DC_CATEGORY, MAX_AC_SIZE, MAX_SYMBOLS, MAX_MAGNITUDE_BITS = range(
    HIST, HIST + 4)
WORDS = HIST + 4

launches = 0  # times the CUDA kernel was launched through the wrapper
launches_by_card: dict[int, int] = {}  # the same count, by card index


@dataclasses.dataclass(frozen=True)
class SymbolStats:
    """One image's statistics, from the (``WORDS``,) int64 buffer."""

    dc_counts: np.ndarray  # (DC_CATS,) int64
    ac_counts: np.ndarray  # (16 * AC_SIZES,) int64
    max_symbols: int
    max_magnitude_bits: int

    def block_bits_bound(self, longest: int) -> int:
        """Bits no block passes when every code is at most ``longest``
        bits long."""
        return self.max_symbols * longest + self.max_magnitude_bits


def _sizes(v: torch.Tensor) -> torch.Tensor:
    """JPEG size of int64 values within int32's range: the bits of |v|
    (0 for 0), by ``frexp``'s exponent of the exact float64."""
    return torch.frexp(v.abs().to(torch.float64)).exponent.to(torch.int64)


def symbol_stats_plain(zz: torch.Tensor,
                       dc_prev: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of one launch (any device): (64, n) int32
    coefficients and the DC before their first block (a (1,) int32
    tensor, or ``None`` for 0) -> the (``WORDS``,) int64 buffer of that
    range alone, the kernel's bit for bit (a category or size past 15
    counted at 15)."""
    n = zz.shape[1]
    x = zz.to(torch.int64)
    before = torch.zeros(1, dtype=torch.int64, device=zz.device)
    if dc_prev is not None:
        before = dc_prev.reshape(1).to(torch.int64)
    diff = x[0] - torch.cat([before, x[0, :-1]])
    diff = (diff + 2**31) % 2**32 - 2**31  # int32 wrap-around
    dc_cat = _sizes(diff)
    ac = x[1:]
    nz = ac != 0
    size = _sizes(ac)
    pos = torch.arange(1, 64, dtype=torch.int64, device=zz.device)[:, None]
    last = torch.cummax(torch.where(nz, pos, 0), dim=0).values
    # the last nonzero position before each one (0, the DC's, to start)
    prev = torch.cat([torch.zeros_like(last[:1]), last[:-1]])
    run = pos - prev - 1
    zrl = torch.where(nz, run >> 4, 0)
    out = torch.zeros(WORDS, dtype=torch.int64, device=zz.device)
    out[:DC_CATS] = torch.bincount(dc_cat.clamp(max=DC_CATS - 1),
                                   minlength=DC_CATS)
    idx = (run & 15) * AC_SIZES + size.clamp(max=AC_SIZES - 1)
    out[AC0:HIST] = torch.bincount(idx[nz], minlength=16 * AC_SIZES)
    out[AC0 + 15 * AC_SIZES] += zrl.sum()
    out[AC0] += n
    symbols = 2 + nz.sum(dim=0) + zrl.sum(dim=0)
    magnitude = dc_cat + torch.where(nz, size, 0).sum(dim=0)
    out[MAX_DC_CATEGORY] = dc_cat.max()
    out[MAX_AC_SIZE] = torch.where(nz, size, 0).max()
    out[MAX_SYMBOLS] = symbols.max()
    out[MAX_MAGNITUDE_BITS] = magnitude.max()
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("symbol_stats")
    fn = lib.symbol_stats_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def stats_buffer(zz_list: list[torch.Tensor]) -> torch.Tensor:
    """The (``WORDS``,) int64 buffer of an image's ranges, on their
    device, not yet pulled: sums over the ranges, maxima over them.  CUDA
    tensors go to the kernel, one launch a range, CPU tensors to the plain
    version; nothing else is tried."""
    if not zz_list:
        raise ValueError("no block range")
    dev = zz_list[0].device
    for zz in zz_list:
        if (zz.dtype != torch.int32 or zz.ndim != 2 or zz.shape[0] != 64
                or zz.shape[1] < 1):
            raise ValueError("each range must be a (64, n) int32 tensor")
        if zz.device != dev:
            raise ValueError("the ranges lie on different devices")
    if dev.type == "cpu":
        parts = torch.stack([
            symbol_stats_plain(zz, None if k == 0 else zz_list[k - 1][0, -1:])
            for k, zz in enumerate(zz_list)])
        out = parts.sum(dim=0)
        out[HIST:] = parts[:, HIST:].max(dim=0).values
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    zz_list = [zz.contiguous() for zz in zz_list]
    out = torch.zeros(WORDS, dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = _build.stream_handle(dev)
        for k, zz in enumerate(zz_list):
            prev = None
            if k:  # the previous range's last DC, element (0, n - 1)
                p = zz_list[k - 1]
                prev = p.data_ptr() + 4 * (p.shape[1] - 1)
            err = lib.symbol_stats_launch(zz.data_ptr(), prev,
                                          out.data_ptr(), zz.shape[1], stream)
            _build.check(err, "symbol_stats")
            _build.count_launch(globals(), dev)
    return out


def stats_from_buffer(buf: np.ndarray) -> SymbolStats:
    """The pulled buffer -> :class:`SymbolStats`; a DC category or an AC
    size outside the dynamic tables raises ``ValueError``, as
    ``huffman.symbol_counts`` does."""
    if buf[MAX_DC_CATEGORY] >= DC_CATS:
        raise ValueError(
            "DC difference magnitude exceeds the dynamic-table range")
    if buf[MAX_AC_SIZE] >= AC_SIZES:
        raise ValueError(
            "AC coefficient magnitude exceeds the dynamic-table range")
    return SymbolStats(buf[:DC_CATS].copy(), buf[AC0:HIST].copy(),
                       int(buf[MAX_SYMBOLS]), int(buf[MAX_MAGNITUDE_BITS]))


def symbol_stats(zz_list: list[torch.Tensor]) -> SymbolStats:
    """An image's block ranges -> its :class:`SymbolStats`, the buffer
    pulled in one copy (one sync)."""
    return stats_from_buffer(stats_buffer(zz_list).cpu().numpy())
