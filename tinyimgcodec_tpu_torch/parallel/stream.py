"""Streaming ingest: a double-buffered host-to-card encode feed, and the
chunked decode of a stream of streams.

The counterpart of the JAX package's ``parallel/stream.py``.  Images come
in chunks of one shape; while the card encodes chunk i, chunk i+1 is
already on its way from pinned host memory (two buffers, taken in turn),
copied with ``non_blocking=True`` on a side ``torch.cuda.Stream``.  The encode of
chunk i waits on the current stream for chunk i's copy event, so the
kernels never read a chunk before it has landed, and the copy of the
next chunk overlaps them and the pull of their bytes.  A short last chunk
is padded with repeats of its last image, so every chunk has one shape,
and the pads are never yielded.  Not carried over: the JAX function's
fallback to the XLA batch on "not tileable", a TPU rule.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from .. import container
from ..device import resolve_device
from ..engine import Engine
from ..ops import transform
from ..pipeline import compress_batch_device


def _chunked(images: Iterable[np.ndarray], n: int):
    """Yield (chunk of block-padded images, true (H, W)); images must
    share one shape."""
    buf: list[np.ndarray] = []
    shape: tuple[int, int] | None = None
    for im in images:
        im = np.ascontiguousarray(np.asarray(im), dtype=np.uint8)
        if shape is None:
            shape = im.shape
        elif im.shape != shape:
            raise ValueError(
                f"stream images must share one shape: {im.shape} vs {shape}")
        buf.append(transform.pad_to_blocks(im))
        if len(buf) == n:
            yield buf, shape
            buf = []
    if buf:
        yield buf, shape


def compress_stream(
    images: Iterable[np.ndarray],
    quality: int = 50,
    chunk: int = 8,
    precision: str = transform.FAST,
    block_index: bool = True,
    index_stride: int = container.INDEX_STRIDE,
    device: str | torch.device | None = None,
) -> Iterator[bytes]:
    """Encode an image stream, yielding one stream an image in order: the
    bytes of ``compress_batch`` of the same images.  Two chunks are in
    flight (see the module docstring); on the CPU (``device="cpu"``) the
    chunks simply follow one another."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if on_card else None
    # two pinned host buffers, taken in turn: chunk i + 2 is written into
    # chunk i's only after chunk i's encode, which waited for its copy and
    # pulled its bytes, has returned
    pinned: list[torch.Tensor] = []

    def stage(batch, i):
        if not on_card:
            return torch.from_numpy(np.stack(batch)), None
        if len(pinned) < 2:
            pinned.append(torch.empty((len(batch), *batch[0].shape),
                                      dtype=torch.uint8, pin_memory=True))
        host = pinned[i % 2]
        np.stack(batch, out=host.numpy())
        with torch.cuda.stream(side):
            staged = host.to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return staged, ready

    def encode(staged, ready, count, true_shape):
        if ready is not None:
            current = torch.cuda.current_stream(dev)
            current.wait_event(ready)
            # made on the side stream, read on this one
            staged.record_stream(current)
        out = compress_batch_device(
            staged, quality, precision=precision, block_index=block_index,
            index_stride=index_stride, true_shape=true_shape, device=dev)
        return out[:count]

    prev = None
    for i, (batch, true_shape) in enumerate(_chunked(images, chunk)):
        count = len(batch)
        batch = batch + [batch[-1]] * (chunk - count)
        staged, ready = stage(batch, i)
        if prev is not None:
            # the card encodes the previous chunk while this one copies
            yield from encode(*prev)
        prev = (staged, ready, count, true_shape)
    if prev is not None:
        yield from encode(*prev)


def decompress_stream(
    streams: Iterable[bytes],
    chunk: int = 8,
    precision: str = transform.EXACT,
    device: str | torch.device | None = None,
) -> Iterator[np.ndarray]:
    """Decode a stream of compressed images, yielding uint8 arrays in
    order: chunks of up to ``chunk`` streams of one header (shape,
    quality, flags) go through ``Engine.decompress_batch``; a header change
    or a full chunk flushes the chunk."""
    eng = Engine(precision, device)
    buf: list[bytes] = []
    key = None
    for data in streams:
        k = container.parse_header(data)
        if buf and (k != key or len(buf) >= chunk):
            yield from eng.decompress_batch(buf)
            buf = []
        key = k
        buf.append(data)
    if buf:
        yield from eng.decompress_batch(buf)
