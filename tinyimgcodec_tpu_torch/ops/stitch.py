"""Stream assembly from ragged block rows: kernel wrapper and plain version.

Takes ``ops/encode1.py``'s outputs -- (N, 52) block rows packed from bit 0
and the (N,) bit counts -- and concatenates the blocks' bit strings into
one stream: blocks of an image back to back, every image's first block
rounded up to a byte boundary (so each image's stream can be cut out).

Returns ``(stream_words (cap_words,) int32 bit patterns, image_start_bits
(B,) int32, total_bits, status)`` like the JAX package's ``stitch_pallas``:
``status`` is 2 exactly when ``total_bits > cap_words * 32``, else 0.  A
word that would land at or beyond ``cap_words`` is dropped, never moved
onto earlier data.

Replaces ``tinyimgcodec_tpu/ops/pallas_stitch.py``
(``_make_kernel_windowed``), a serial bit appender.  On the card it is one
launch after a zero fill of its scan state (``csrc/stitch.cu``): spans of
blocks find their offsets by a single-pass look-back scan, and every word
of the stream is gathered from the funnel-shifted rows of the blocks that
cover it and stored whole -- no atomics on the stream, no zero fill of it
-- with the tail zeros, image starts, total and status from the same
launch.  Bound: bytes.  It does not go through ``place``.

Precondition: ``0 <= bits <= 1664`` (a row holds 52 words) and a row is
zero past its block's bits, as ``ops/encode1.py`` gives them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .encode2 import image_offsets

BLOCK_WORDS = 52
SPAN = 256  # blocks a CTA of the kernel takes (csrc/stitch.cu)
_M32 = 0xFFFFFFFF

launches = 0  # times the CUDA kernels were launched through the wrapper
launches_by_card: dict[int, int] = {}  # the same count, by card index


def _check(words: torch.Tensor, bits: torch.Tensor, nb: int,
           cap_words: int) -> int:
    n = words.shape[0]
    if words.dtype != torch.int32 or words.shape != (n, BLOCK_WORDS):
        raise ValueError("words must be an (N, 52) int32 tensor")
    if bits.dtype != torch.int32 or bits.shape != (n,):
        raise ValueError("bits must be an (N,) int32 tensor")
    if bits.device != words.device:
        raise ValueError("words and bits lie on different devices")
    if nb < 1 or n == 0 or n % nb:
        raise ValueError(f"N={n} is not a positive multiple of nb={nb}")
    if not 0 < cap_words < 1 << 31:
        raise ValueError(f"cap_words {cap_words} out of range")
    if n * BLOCK_WORDS * 32 >= 1 << 31:
        # bit offsets and the total are int32 in the kernels
        raise ValueError(f"N={n} blocks may exceed 2**31 stream bits")
    return n


def stitch_plain(words: torch.Tensor, bits: torch.Tensor, nb: int,
                 cap_words: int):
    """Plain PyTorch version (any device): every block's row shifted by
    its bit phase into 53 words, then an ``index_add_`` into a zeroed
    stream (blocks' bits never overlap, so ADD == OR); int64 carries."""
    cap_words = int(cap_words)
    n = _check(words, bits, nb, cap_words)
    dev = words.device
    off, starts, total = image_offsets(bits.to(torch.int64), nb)
    w = words.to(torch.int64) & _M32
    zero = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    cur = torch.cat([w, zero], dim=1)   # word j of the row (0 at j = 52)
    prev = torch.cat([zero, w], dim=1)  # word j - 1 (0 at j = 0)
    sh = (off & 31).reshape(n, 1)
    out = (cur >> sh) | (((prev << ((32 - sh) & 31)) & _M32) * (sh > 0))
    j = torch.arange(BLOCK_WORDS + 1, device=dev).reshape(1, -1)
    owned = ((sh + bits.to(torch.int64).reshape(n, 1) + 31) >> 5)
    idx = (off >> 5).reshape(n, 1) + j
    keep = (j < owned) & (idx < cap_words)
    stream = torch.zeros(cap_words, dtype=torch.int64, device=dev)
    stream.index_add_(0, idx[keep], out[keep])
    stream = torch.where(stream >= 1 << 31, stream - (1 << 32), stream)
    total_t = torch.tensor(total, dtype=torch.int32, device=dev)
    status = torch.tensor(2 if total > cap_words * 32 else 0,
                          dtype=torch.int32, device=dev)
    return stream.to(torch.int32), starts.to(torch.int32), total_t, status


def _lib() -> ctypes.CDLL:
    lib = _build.load("stitch")
    fn = lib.stitch_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def launch_kernels(words: torch.Tensor, bits: torch.Tensor, nb: int,
                   stream: torch.Tensor) -> torch.Tensor:
    """The zero fill of the scan state and the kernel launch, writing
    every word of ``stream`` whatever it held; returns the summary
    (B + 2,) int32 = image starts, total bits, status.  What
    :func:`stitch` does after allocating the stream (a measurement can
    time just this)."""
    n = words.shape[0]
    dev = words.device
    # ticket, the tail's chunk ticket, one state word a span of SPAN blocks
    scan = torch.zeros((2 + -(-n // SPAN),), dtype=torch.int64, device=dev)
    summary = torch.empty((n // nb + 2,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().stitch_launch(
            words.data_ptr(), bits.data_ptr(), scan.data_ptr(),
            stream.data_ptr(), summary.data_ptr(), n, int(nb),
            stream.shape[0], _build.stream_handle(dev),
        )
    _build.check(err, "stitch")
    return summary


def stitch(words: torch.Tensor, bits: torch.Tensor, nb: int, cap_words: int):
    """See the module docstring.  CUDA tensors go to the kernel, CPU
    tensors to the plain version; nothing else is tried."""
    if words.device.type == "cpu":
        return stitch_plain(words, bits, nb, cap_words)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    cap_words = int(cap_words)
    n = _check(words, bits, nb, cap_words)
    words = words.contiguous()
    bits = bits.contiguous()
    nimg = n // nb
    stream = torch.empty(cap_words, dtype=torch.int32, device=words.device)
    summary = launch_kernels(words, bits, nb, stream)
    _build.count_launch(globals(), words.device)
    return stream, summary[:nimg], summary[nimg], summary[nimg + 1]
