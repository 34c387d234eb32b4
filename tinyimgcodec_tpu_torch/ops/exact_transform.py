"""Exact (float64) block transform: kernel wrapper and plain version.

(N, 64) uint8 row-major 8x8 pixel blocks -> (64, N) int32 quantized
zig-zag coefficients (coefficient-major, the layout the encode kernel
reads with contiguous loads) equal to the float64 oracle's
(``golden.quantize(golden.block_dct(x - 128))``, scipy's DCT) in every
block, an (N,) int32 per-block flag that is 1 when any coefficient's
rounding lies within 1e-9 of a tie, and the count of flagged blocks.

Replaces ``tinyimgcodec_tpu/ops/pallas_exact.py`` (``_make_kernel``, used
by ``exact_transform_pallas_cm`` and ``exact_transform_pallas_u32``).  The
TPU kernel emulates wide arithmetic with float32 pairs; the card computes
the same function in ``double`` (``csrc/exact_transform.cu``), its two 8x8
products on the FP64 tensor cores.  A product summed in another order
than scipy's lands within about 1e-13 of the oracle's coefficient, so a
coefficient more than 1e-9 from a rounding tie rounds alike; a true tie
(a DC at quality 50 whenever a block's sum is 64 mod 128) rounds
whichever way scipy's own arithmetic lands.  So each flagged block is
computed again, in the same call, in scipy's own order
(:func:`oracle_dct8`: the operations of pocketfft's type-2 DCT of length 8,
with its twiddles bit for bit) and quantized by IEEE division by the
float64 divisors, as the oracle does.  The kernel, the plain version
below and the TPU kernel may flag different blocks; their coefficients
agree in every block all the same.

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

# The constants of scipy's float64 DCT-II of length 8 (``scipy.fftpack.dct``
# through pocketfft; ducc0's ``T_dcst23``, the same code): the real and
# imaginary parts of the 8th root of unity of its backward real FFT's
# radix-2 pass, the cosines (2 pi k / 32), k = 1..7, of its post-twiddle,
# and sqrt(2) / 2 of the orthonormal DC.  As that code computes them, not
# correctly rounded: the two parts of the root differ in the last bit.
_FFT_ROOT = (float.fromhex("0x1.6a09e667f3bccp-1"),
             float.fromhex("0x1.6a09e667f3bcdp-1"))
_DCT_TWIDDLE = tuple(float.fromhex(h) for h in (
    "0x1.f6297cff75cbp-1", "0x1.d906bcf328d46p-1", "0x1.a9b66290ea1a3p-1",
    "0x1.6a09e667f3bccp-1", "0x1.1c73b39ae68c8p-1", "0x1.87de2a6aea963p-2",
    "0x1.8f8b83c69a60ap-3"))
_HALF_SQRT2 = float.fromhex("0x1.6a09e667f3bcdp-1")

launches = 0  # times the CUDA kernel was launched through the wrapper
launches_by_card: dict[int, int] = {}  # the same count, by card index


def oracle_dct8(c: list) -> list:
    """The orthonormal DCT-II of length 8 of ``c`` (eight float64 tensors
    or arrays of one shape, the eight points), in the operations and order
    of scipy's: the type-2 DCT of pocketfft (``T_dcst23``: a pre-pass,
    a backward real FFT of factors 2 then 4 scaled by 1/4, a post-twiddle,
    the DC times sqrt(2) / 2).  Elementwise only, so every element rounds
    as scipy rounds it."""
    x = list(c)
    x[0] = x[0] * 2.0
    x[7] = x[7] * 2.0
    for k in (1, 3, 5):
        x[k], x[k + 1] = x[k + 1] + x[k], x[k + 1] - x[k]
    # radix-2 pass (one group of four)
    wr, wi = _FFT_ROOT
    tr2, ti2 = x[1] - x[5], x[2] + x[6]
    y = [x[0] + x[7], x[1] + x[5], x[2] - x[6], 2.0 * x[3],
         x[0] - x[7], wr * tr2 - wi * ti2, wr * ti2 + wi * tr2, -2.0 * x[4]]
    # radix-4 pass (two groups), then the scale
    r = [None] * 8
    for k in (0, 1):
        a, b, c2, d = y[4 * k:4 * k + 4]
        tr2, tr1 = a + d, a - d
        tr3, tr4 = 2.0 * b, 2.0 * c2
        r[k], r[k + 4] = tr2 + tr3, tr2 - tr3
        r[k + 6], r[k + 2] = tr1 + tr4, tr1 - tr4
    r = [v * 0.25 for v in r]
    tw = _DCT_TWIDDLE
    out = [r[0] * _HALF_SQRT2] + [None] * 7
    for k, kc in ((1, 7), (2, 6), (3, 5)):
        t1 = tw[k - 1] * r[kc] + tw[kc - 1] * r[k]
        t2 = tw[k - 1] * r[k] - tw[kc - 1] * r[kc]
        out[k], out[kc] = 0.5 * (t1 + t2), 0.5 * (t1 - t2)
    out[4] = r[4] * tw[3]
    return out


def oracle_coefficients(pixels: torch.Tensor,
                        tables: CodecTables) -> torch.Tensor:
    """(k, 64) uint8 blocks -> (k, 64) int32 zig-zag coefficients in the
    float64 oracle's arithmetic: level shift, :func:`oracle_dct8` over the
    columns (axis -2) then the rows, IEEE division by the divisors, round
    half to even."""
    k = pixels.shape[0]
    x = pixels.reshape(k, 8, 8).to(torch.float64) - 128.0
    y = torch.stack(oracle_dct8([x[:, i, :] for i in range(8)]), dim=1)
    c = torch.stack(oracle_dct8([y[:, :, j] for j in range(8)]), dim=2)
    q = torch.round(c / tables.divisors).to(torch.int32)
    return q.reshape(k, 64)[:, tables.zigzag]


def exact_transform_plain(
    pixels: torch.Tensor, tables: CodecTables
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (any device), float64, fixed summation order:
    ascending i in stage 1, ascending j in stage 2, a rounding after every
    multiply and every add; the flagged blocks then settled by
    :func:`oracle_coefficients`."""
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
    count = flags.sum(dtype=torch.int64)
    if int(count):  # listed by topk: a pipeline on the CPU opens no nonzero
        idx = torch.topk(flags, int(count), sorted=False).indices
        zz[idx] = oracle_coefficients(pixels[idx], tables)
    return zz.T.contiguous(), flags, count


def _lib() -> ctypes.CDLL:
    lib = _build.load("exact_transform")
    fn = lib.exact_transform_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def exact_transform(
    pixels: torch.Tensor, tables: CodecTables
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, 64) uint8 -> ((64, N) int32 zig-zag coefficients, the oracle's
    in every block; (N,) int32 tie flags; the 0-d int64 count of flagged
    blocks, on the pixels' device: read it with another read of the same
    call, not with a sync of its own).  CUDA tensors go to the kernel, CPU
    tensors to the plain version; nothing else is tried."""
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
    flagged = torch.empty((), dtype=torch.int64, device=pixels.device)
    lib = _lib()
    with torch.cuda.device(pixels.device):
        err = lib.exact_transform_launch(
            pixels.data_ptr(), tables.dct_basis.data_ptr(),
            tables.recip_divisors.data_ptr(), tables.divisors.data_ptr(),
            zz.data_ptr(), flags.data_ptr(), flagged.data_ptr(), n,
            _build.stream_handle(pixels.device),
        )
    _build.check(err, "exact_transform")
    _build.count_launch(globals(), pixels.device)
    return zz, flags, flagged
