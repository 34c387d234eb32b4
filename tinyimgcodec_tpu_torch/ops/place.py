"""Word placement: kernel wrapper and plain version.

Takes the encode kernel's outputs -- (N, 56) block rows whose words are
already shifted to their final bit phase, and the (2, N) meta of global
bit offsets and bit counts -- and ORs row b into one stream at word
``offset_b >> 5``.  Returns ``(stream_words (cap_words,) int32 bit
patterns, image_start_bits (B,), total_bits, overflow)`` like the JAX
package's ``assemble_cm``.

Replaces the three placement kernel generations of
``tinyimgcodec_tpu/ops/pallas_place.py`` (``_make_kernel_v4``,
``_make_kernel_v3``, ``_make_kernel``), which are one function.  On the
card it is a gather (``csrc/place.cu``): one launch whose threads follow
the output words, each the OR of the few consecutive blocks that cover it,
found by bisection in the offsets and stored whole -- no atomics, no zero
fill before it, and image starts, total and overflow flag come out of the
same launch.  Bound: bytes.

Overflow is exactly ``total_bits > cap_words * 32`` (no 32-bit wrap of the
limit).  A word that would land at or beyond ``cap_words`` is dropped,
never moved onto earlier data.

Precondition, which ``ops/encode2.py`` guarantees and the kernel relies
on (the plain version only on the last): offsets ascend, a block's bits
end before the next block begins, and a row is zero outside its block's
bits.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

ROW_WORDS = 56

launches = 0  # times the CUDA kernel was launched through the wrapper
launches_by_card: dict[int, int] = {}  # the same count, by card index


def _check(packed: torch.Tensor, meta: torch.Tensor, nb: int) -> int:
    n = packed.shape[0]
    if packed.dtype != torch.int32 or packed.shape != (n, ROW_WORDS):
        raise ValueError("packed must be an (N, 56) int32 tensor")
    if meta.dtype != torch.int32 or meta.shape != (2, n):
        raise ValueError("meta must be a (2, N) int32 tensor")
    if meta.device != packed.device:
        raise ValueError("packed and meta lie on different devices")
    if n == 0 or n % nb:
        raise ValueError(f"N={n} is not a positive multiple of nb={nb}")
    return n


def _summary(meta: torch.Tensor, nb: int, cap_words: int):
    off = meta[0]
    total_bits = off[-1] + meta[1, -1]
    starts = off[::nb]
    # total_bits is int32: a limit of 2**31 bits or more is never passed
    overflow = total_bits > min(cap_words * 32, (1 << 31) - 1)
    return starts, total_bits, overflow


def place_plain(packed: torch.Tensor, meta: torch.Tensor, nb: int,
                cap_words: int):
    """Plain PyTorch version (any device): an ``index_add_`` of every row
    word into a zeroed stream (blocks' bits never overlap, so ADD == OR);
    words are carried as int64.  Words outside the capacity go to one
    spare word past it, dropped after (no boolean mask: no host sync)."""
    n = _check(packed, meta, nb)
    dev = packed.device
    words = packed.to(torch.int64) & 0xFFFFFFFF
    idx = (meta[0].to(torch.int64) >> 5).reshape(n, 1) + torch.arange(
        ROW_WORDS, device=dev
    ).reshape(1, ROW_WORDS)
    keep = (idx < cap_words) & (idx >= 0)
    stream = torch.zeros(cap_words + 1, dtype=torch.int64, device=dev)
    stream.index_add_(0, torch.where(keep, idx, cap_words).reshape(-1),
                      words.reshape(-1))
    stream = stream[:cap_words]
    stream = torch.where(stream >= 1 << 31, stream - (1 << 32), stream)
    return (stream.to(torch.int32),) + _summary(meta, nb, cap_words)


def _lib() -> ctypes.CDLL:
    lib = _build.load("place")
    fn = lib.place_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def launch_kernel(packed: torch.Tensor, meta: torch.Tensor,
                  stream: torch.Tensor, nb: int = 0,
                  summary: torch.Tensor | None = None) -> None:
    """The ``place_kernel`` launch alone: writes every word of ``stream``
    and, if given, ``summary`` (B + 2,) int32 = image starts, total bits,
    overflow.  What :func:`place` does after its allocations (a
    measurement can time just this)."""
    off = meta.data_ptr()  # row 0; row 1, the bit counts, follows it
    with torch.cuda.device(packed.device):
        err = _lib().place_launch(
            packed.data_ptr(), off, off + 4 * meta.stride(0),
            stream.data_ptr(),
            None if summary is None else summary.data_ptr(),
            packed.shape[0], int(nb), stream.shape[0],
            _build.stream_handle(packed.device),
        )
    _build.check(err, "place")


def place(packed: torch.Tensor, meta: torch.Tensor, nb: int, cap_words: int):
    """See the module docstring.  CUDA tensors go to the kernel, CPU
    tensors to the plain version; nothing else is tried."""
    if packed.device.type == "cpu":
        return place_plain(packed, meta, nb, cap_words)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    n = _check(packed, meta, nb)
    cap_words = int(cap_words)
    if not 0 < cap_words < 1 << 31:
        raise ValueError(f"cap_words {cap_words} out of range")
    packed = packed.contiguous()
    meta = meta.contiguous()
    nimg = n // nb
    i32 = dict(dtype=torch.int32, device=packed.device)
    stream = torch.empty(cap_words, **i32)
    summary = torch.empty(nimg + 2, **i32)
    launch_kernel(packed, meta, stream, nb, summary)
    _build.count_launch(globals(), packed.device)
    # the flag is 0 or 1: its first byte read as a bool, no launch
    overflow = summary.view(torch.bool)[4 * nimg + 4]
    return stream, summary[:nimg], summary[nimg], overflow
