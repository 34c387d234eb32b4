"""Exact (float64) block transform: kernel wrapper and plain version.

(N, 64) uint8 row-major 8x8 pixel blocks -> (64, N) int32 quantized
zig-zag coefficients (coefficient-major, the layout the encode kernel
reads with contiguous loads) and an (N,) int32 per-block flag that is 1
when any coefficient's rounding lies within 1e-9 of a tie.

Replaces ``tinyimgcodec_tpu/ops/pallas_exact.py`` (``_make_kernel``, used
by ``exact_transform_pallas_cm`` and ``exact_transform_pallas_u32``).  The
TPU kernel emulates wide arithmetic with float32 pairs; the card computes
the same function in ``double`` (``csrc/exact_transform.cu``), its two 8x8
products on the FP64 tensor cores.  The kernel, the plain version below
and the TPU kernel round differently, so they may flag different blocks
and differ in a flagged block's coefficients -- which is allowed: the
caller recomputes every flagged block with the float64 host oracle, and an
unflagged coefficient is more than 1e-9 from a tie while the arithmetic
error is around 1e-13.

Bound on the card: bytes (64 B in, 260 B out per block).  The plain
version sums in a fixed order (a rounding after every multiply and every
add); it serves CPU tensors and is the yardstick of the kernel's
correctness, not of its speed.
"""

from __future__ import annotations

import ctypes

import torch

from ..tables import CodecTables
from . import _build

TIE_SNAP = 1e-9

launches = 0  # times the CUDA kernel was launched through the wrapper
launches_by_card: dict[int, int] = {}  # the same count, by card index


def exact_transform_plain(
    pixels: torch.Tensor, tables: CodecTables
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (any device), float64, fixed summation order:
    ascending i in stage 1, ascending j in stage 2, a rounding after every
    multiply and every add."""
    n = pixels.shape[0]
    d = tables.dct_basis  # (8, 8) float64, d[u, i]
    x = pixels.reshape(n, 8, 8).to(torch.float64) - 128.0  # x[n, i, j]
    # stage 1: y[n, u, j] = sum_i d[u, i] * x[n, i, j]
    y = d[:, 0].reshape(1, 8, 1) * x[:, 0, :].reshape(n, 1, 8)
    for i in range(1, 8):
        y = y + d[:, i].reshape(1, 8, 1) * x[:, i, :].reshape(n, 1, 8)
    # stage 2: c[n, u, v] = sum_j y[n, u, j] * d[v, j]
    c = y[:, :, 0].reshape(n, 8, 1) * d[:, 0].reshape(1, 1, 8)
    for j in range(1, 8):
        c = c + y[:, :, j].reshape(n, 8, 1) * d[:, j].reshape(1, 1, 8)
    q = c * tables.recip_divisors
    r = torch.round(q)  # half to even
    tie = ((q - r).abs() - 0.5).abs() < TIE_SNAP
    flags = tie.reshape(n, 64).any(dim=1).to(torch.int32)
    zz = r.to(torch.int32).reshape(n, 64)[:, tables.zigzag]
    return zz.T.contiguous(), flags


def _lib() -> ctypes.CDLL:
    lib = _build.load("exact_transform")
    fn = lib.exact_transform_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def exact_transform(
    pixels: torch.Tensor, tables: CodecTables
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 64) uint8 -> ((64, N) int32 zig-zag coefficients, (N,) int32
    tie flags).  CUDA tensors go to the kernel, CPU tensors to the plain
    version; nothing else is tried."""
    if pixels.dtype != torch.uint8 or pixels.ndim != 2 or pixels.shape[1] != 64:
        raise ValueError("pixels must be an (N, 64) uint8 tensor")
    if tables.device != pixels.device:
        raise ValueError("tables and pixels lie on different devices")
    if pixels.device.type == "cpu":
        return exact_transform_plain(pixels, tables)
    if pixels.device.type != "cuda":
        raise ValueError(f"unsupported device {pixels.device}")
    pixels = pixels.contiguous()
    n = pixels.shape[0]
    zz = torch.empty((64, n), dtype=torch.int32, device=pixels.device)
    flags = torch.empty((n,), dtype=torch.int32, device=pixels.device)
    lib = _lib()
    with torch.cuda.device(pixels.device):
        err = lib.exact_transform_launch(
            pixels.data_ptr(), tables.dct_basis.data_ptr(),
            tables.recip_divisors.data_ptr(), zz.data_ptr(),
            flags.data_ptr(), n, _build.stream_handle(pixels.device),
        )
    _build.check(err, "exact_transform")
    _build.count_launch(globals(), pixels.device)
    return zz, flags
