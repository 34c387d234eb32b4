"""Exact (float64) decode transform: kernel wrapper and plain version.

(B, nb, 64) int32 zig-zag coefficient rows, the DC of each image still as
DPCM differences (``entropy_decode``'s output, or the host-entropy leg's
widened rows), -> the (B, h, w) uint8 images, cropped, in raster order,
equal to the float64 oracle's (``container.decompress``) in every block,
and the count of blocks that held a value within 1e-9 of a floor
boundary.  Per block: the running DC (int32 wrap-around, as the oracle's
int64 sum cast back), the oracle's dequantization
(``tables.dequant_steps``), the separable 8x8 inverse DCT in float64,
``+ 128``, floor, clip to 0..255.

The separable sums run in a fixed order of their own (over the columns,
then over the rows, each as even and odd halves in ascending order, one
rounding a multiply and an add: :func:`separable_values`), not scipy's,
so a value lands within about 1e-12 of the oracle's: one more than 1e-9
from an integer floors as the oracle's does.
A block with a value closer than that inside (0.5, 255.5) is flagged and
computed again in scipy's own operations and order (:func:`oracle_idct8`:
pocketfft's type-3 DCT of length 8, with its twiddles bit for bit, the
columns then the rows), clipped and truncated as the oracle does.

It replaces no TPU kernel: the JAX package decodes with an XLA program
(``ops/transform.py``).  On the card: ``csrc/exact_inverse.cu``, one call
of two kernels (the running DC, then the transform) and a memset; the
bytes (256 B in, 64 B out a block) would allow 19 us for the 49-image
corpus, the FP64 pipes set its time.
The plain version follows the kernel's arithmetic step for step, so both
give the same pixels and the same count; it serves CPU tensors and is
the kernel's yardstick of correctness, not of speed.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..constants import INVERSE_ZIGZAG
from ..tables import DecodeTables, dct_basis
from . import _build
from .exact_transform import _DCT_TWIDDLE, _FFT_ROOT
from .transform import undo_dpcm, unblockify

# a value this close to an integer may floor the other way in the oracle's
# arithmetic (scipy sums in another order)
FLOOR_TIE_EPS = 1e-9
SCAN_BLOCKS = 2048  # blocks a CTA of the running-DC kernel (its scratch)

_SQRT2 = float.fromhex("0x1.6a09e667f3bcdp+0")

launches = 0  # times the CUDA kernel was launched through the wrapper
launches_by_card: dict[int, int] = {}  # the same count, by card index


def oracle_idct8(c: list) -> list:
    """The orthonormal inverse DCT (DCT-III) of length 8 of ``c`` (eight
    float64 tensors or arrays of one shape, the eight points), in the
    operations and order of scipy's (``scipy.fftpack.idct``, norm
    "ortho"): the type-3 branch of pocketfft's ``T_dcst23`` (the DC times
    sqrt(2), a pre-twiddle, a forward real FFT of factors 4 then 2 scaled
    by 1/4, a butterfly).  Elementwise only, so every element rounds as
    scipy rounds it; the twin of ``exact_transform.oracle_dct8``."""
    tw = _DCT_TWIDDLE
    x = list(c)
    x[0] = x[0] * _SQRT2
    for k, kc in ((1, 7), (2, 6), (3, 5)):
        t1, t2 = x[k] + x[kc], x[k] - x[kc]
        x[k] = tw[k - 1] * t2 + tw[kc - 1] * t1
        x[kc] = tw[k - 1] * t1 - tw[kc - 1] * t2
    x[4] = x[4] * (2.0 * tw[3])
    # radix-4 pass (two groups)
    h = [None] * 8
    for k in (0, 1):
        s1, s2 = x[k + 6] + x[k + 2], x[k] + x[k + 4]
        h[4 * k + 2] = x[k + 6] - x[k + 2]
        h[4 * k + 1] = x[k] - x[k + 4]
        h[4 * k], h[4 * k + 3] = s2 + s1, s2 - s1
    # radix-2 pass (one group of four), then the scale
    wr, wi = _FFT_ROOT
    tr2, ti2 = wr * h[5] + wi * h[6], wr * h[6] - wi * h[5]
    o = [h[0] + h[4], h[1] + tr2, ti2 + h[2], h[3],
         -h[7], h[1] - tr2, ti2 - h[2], h[0] - h[4]]
    o = [v * 0.25 for v in o]
    out = list(o)
    for k in (1, 3, 5):
        out[k], out[k + 1] = o[k] - o[k + 1], o[k + 1] + o[k]
    return out


def dequantized(zz: torch.Tensor, tables: DecodeTables) -> torch.Tensor:
    """(B, nb, 64) int32 rows, DC as DPCM differences -> (B * nb, 8, 8)
    float64 row-major coefficients: the running DC of each image (int32
    wrap-around), then the oracle's three dequantization steps."""
    rows = undo_dpcm(zz).reshape(-1, 64)
    natural = torch.as_tensor(INVERSE_ZIGZAG, dtype=torch.long,
                              device=zz.device)
    c = rows[:, natural].to(torch.float64).reshape(-1, 8, 8)
    steps = tables.dequant.reshape(3, 8, 8)
    return c / steps[0] * steps[1] * steps[2]


def _inverse8(a: list, d: torch.Tensor) -> list:
    """out[i] = sum_u d[u, i] a[u] for i = 0..7 (``a``: eight tensors of
    one shape), as the kernel's ``inverse8`` sums it: even and odd halves
    ``e = d[0, i] a[0] + d[2, i] a[2] + ...``, ``o = d[1, i] a[1] + ...``
    in ascending u, then ``out[i] = e + o`` and ``out[7 - i] = e - o``
    (the basis is symmetric about the middle), one rounding a step."""
    out = [None] * 8
    for i in range(4):
        e, o = d[0, i] * a[0], d[1, i] * a[1]
        for u in (2, 4, 6):
            e = e + d[u, i] * a[u]
            o = o + d[u + 1, i] * a[u + 1]
        out[i], out[7 - i] = e + o, e - o
    return out


def separable_values(c: torch.Tensor) -> torch.Tensor:
    """(k, 8, 8) dequantized coefficients -> the (k, 8, 8) values
    ``x + 128`` in the kernel's arithmetic: :func:`_inverse8` over the
    columns (``y[i, v] = sum_u d[u, i] c[u, v]``), then over the rows
    (``x[i, j] = sum_v y[i, v] d[v, j]``)."""
    d = torch.from_numpy(dct_basis()).to(c.device)  # d[u, i]
    y = torch.stack(_inverse8([c[:, u, :] for u in range(8)], d), dim=1)
    x = torch.stack(_inverse8([y[:, :, v] for v in range(8)], d), dim=2)
    return x + 128.0


def tie_flags(values: torch.Tensor) -> torch.Tensor:
    """(k, 8, 8) values -> (k,) bool: the blocks holding a value within
    ``FLOOR_TIE_EPS`` of an integer inside (0.5, 255.5), where the oracle's
    arithmetic might floor the other way."""
    near = (values - torch.round(values)).abs() < FLOOR_TIE_EPS
    return (near & (values > 0.5) & (values < 255.5)).reshape(
        -1, 64).any(dim=1)


def oracle_pixels(c: torch.Tensor) -> torch.Tensor:
    """(k, 8, 8) coefficients dequantized as the oracle does -> (k, 8, 8)
    uint8 in the oracle's arithmetic: :func:`oracle_idct8` over the
    columns (axis -2) then the rows, ``+ 128``, clip, truncation."""
    y = torch.stack(oracle_idct8([c[:, u, :] for u in range(8)]), dim=1)
    x = torch.stack(oracle_idct8([y[:, :, v] for v in range(8)]), dim=2)
    # fmin / fmax: a NaN clips to 0, as the kernel's does
    return torch.fmin(torch.fmax(x + 128.0, x.new_tensor(0.0)),
                      x.new_tensor(255.0)).to(torch.uint8)


def exact_inverse_plain(zz: torch.Tensor, h: int, w: int,
                        tables: DecodeTables
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (any device): the kernel's steps elementwise
    in float64, its pixels and its count bit for bit."""
    b, nb, _ = zz.shape
    c = dequantized(zz, tables)
    values = separable_values(c)
    flags = tie_flags(values)
    # floor, clip; a value that is not above 0.5 (a NaN too) is 0
    pix = torch.where(values > 0.5,
                      torch.clamp(torch.floor(values), max=255.0),
                      torch.zeros((), dtype=torch.float64, device=zz.device)
                      ).to(torch.uint8)
    count = flags.sum(dtype=torch.int64)
    if int(count):  # listed by topk: a pipeline on the CPU opens no nonzero
        idx = torch.topk(flags.to(torch.int32), int(count),
                         sorted=False).indices
        pix[idx] = oracle_pixels(c[idx])
    bh, bw = -(-h // 8), -(-w // 8)
    imgs = unblockify(pix.reshape(b, nb, 8, 8), bh * 8, bw * 8)
    return imgs[:, :h, :w].contiguous(), count


@functools.cache
def _basis() -> ctypes.Array:
    """The plain version's DCT basis, the same 64 numbers, as the launch
    takes them (host memory: the kernel gets them by value)."""
    return (ctypes.c_double * 64)(*dct_basis().reshape(64).tolist())


def _lib() -> ctypes.CDLL:
    lib = _build.load("exact_inverse")
    fn = lib.exact_inverse_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def exact_inverse(zz: torch.Tensor, h: int, w: int, tables: DecodeTables
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, nb, 64) int32 zig-zag rows, DC as DPCM differences, nb =
    ceil(h / 8) * ceil(w / 8) -> ((B, h, w) uint8 images, the oracle's
    pixels; the 0-d int64 count of flagged blocks, on the rows' device:
    read it after the pixels, with no sync of its own).  CUDA tensors go
    to the kernel, CPU tensors to the plain version; nothing else is
    tried."""
    if zz.dtype != torch.int32 or zz.ndim != 3 or zz.shape[2] != 64:
        raise ValueError("zz must be a (B, nb, 64) int32 tensor")
    b, nb, _ = zz.shape
    bh, bw = -(-h // 8), -(-w // 8)
    if b < 1 or h < 1 or w < 1 or nb != bh * bw:
        raise ValueError(f"{nb} blocks an image do not make {h}x{w}")
    if tables.device != zz.device:
        raise ValueError("tables and coefficients lie on different devices")
    if zz.device.type == "cpu":
        return exact_inverse_plain(zz, h, w, tables)
    if zz.device.type != "cuda":
        raise ValueError(f"unsupported device {zz.device}")
    zz = zz.contiguous()
    dev = zz.device
    out = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    dc = torch.empty((b * nb,), dtype=torch.int32, device=dev)  # running DC
    # [0] the running-DC kernel's ticket, [1] the flagged count, [2 + g]
    # its CTA g's state
    scan = torch.empty((2 + b * -(-nb // SCAN_BLOCKS),), dtype=torch.int64,
                       device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.exact_inverse_launch(
            zz.data_ptr(), _basis(), tables.dequant.data_ptr(),
            out.data_ptr(), dc.data_ptr(), scan.data_ptr(), b, bw, bh, h, w,
            int(tables.divides), _build.stream_handle(dev),
        )
    _build.check(err, "exact_inverse")
    _build.count_launch(globals(), dev)
    return out, scan[1]
