"""Top-level one-call codec API of the port.

``compress`` / ``compress_batch`` / ``decompress`` / ``decompress_batch``
mirror the JAX package's entry points and run on the CUDA card.
``backend``:

- ``"auto"`` / ``"torch"``: the device pipeline (``pipeline.py``) on
  ``device`` (``None`` = the card; without a card this raises
  ``RuntimeError`` -- there is no quiet fall-back to the CPU; pass
  ``device="cpu"`` to run the kernels' plain versions);
- ``"host"``: the float64 numpy/scipy oracle (``container.py``), which
  needs no device.

``compress(..., auto_generate_huffman_table=True)`` codes the image with
Huffman tables built for it (``Engine.compress``); ``compress_batch``
takes no such switch, as in the JAX package.  Decode takes TICX-indexed
streams through the entropy decode kernel and everything else through the
C host entropy decoder plus the device transform (``engine.py`` says which
stream goes where).

Each call is a ``codec.<entry>`` span of ``profiling.span`` (recorded
while a torch profiler is on); the two decode calls' spans count the
images each decode leg took (``kernel``, ``host_entropy``,
``host_decoder``: ``Engine.decode_stats``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import container, profiling
from .config import CodecConfig
from .engine import Engine
from .pipeline import compress_batch_device

_BACKENDS = ("auto", "torch", "host")


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")


def compress(
    image: np.ndarray,
    quality: int = 50,
    auto_generate_huffman_table: bool = False,
    backend: str = "auto",
    precision: str = "exact",
    block_index: bool | None = None,
    index_stride: int = 64,
    config: CodecConfig | None = None,
    device: str | torch.device | None = None,
) -> bytes:
    """Grayscale image (H, W) -> compressed bytes.

    precision: "exact" (byte-identical to the float64 oracle) or "fast"
    (the float32 transform in the encode kernel's own order: bytes that
    are the same on every device, and differ from exact mode's where a
    float32 sum lands on the other side of a rounding tie).
    block_index: append the TICX block-offset trailer (default on).
    config: a validated CodecConfig; overrides the loose kwargs.
    An image of more than 16 Mi pixels is encoded in block ranges of one
    kernel call each (``pipeline.compress_image``), with the same bytes.
    """
    if config is None:
        config = CodecConfig(
            quality=quality,
            precision=precision,
            auto_huffman_table=auto_generate_huffman_table,
            block_index=block_index,
            index_stride=index_stride,
        )
    _check_backend(backend)
    image = np.asarray(image)
    if image.ndim != 2:
        raise ValueError("expected a 2-D grayscale image")
    with profiling.span("codec.compress"):
        if backend == "host":
            return container.compress(
                image, config.quality, config.auto_huffman_table,
                block_index=config.block_index,
                index_stride=config.index_stride,
            )
        return Engine(config.precision, device).compress(
            image, config.quality,
            auto_table=config.auto_huffman_table,
            block_index=config.block_index,
            index_stride=config.index_stride,
        )


def compress_batch(
    images,
    quality: int = 50,
    backend: str = "auto",
    precision: str = "exact",
    block_index: bool | None = None,
    index_stride: int = 64,
    device: str | torch.device | None = None,
) -> list[bytes]:
    """(B, H, W) same-shaped grayscale images -> list of compressed bytes.

    ``images`` may be a numpy array (any H, W >= 8; odd shapes are padded
    and the header keeps the true size), a block-aligned uint8
    ``torch.Tensor`` already on the card, which skips the host->device
    transfer, or a list of (H, W) arrays of several shapes (each run of
    one shape is a batch).  Images of more than 16 Mi pixels are encoded
    one at a time in block ranges.
    """
    config = CodecConfig(
        quality=quality, precision=precision, block_index=block_index,
        index_stride=index_stride,
    )
    _check_backend(backend)
    with profiling.span("codec.compress_batch"):
        if backend == "host":
            if isinstance(images, torch.Tensor):
                images = images.cpu().numpy()
            return [
                container.compress(
                    im, config.quality, block_index=config.block_index,
                    index_stride=config.index_stride,
                )
                for im in np.asarray(images)
            ]
        return compress_batch_device(
            images, quality=config.quality, precision=config.precision,
            block_index=config.block_index,
            index_stride=config.index_stride, device=device,
        )


def decompress(data: bytes, backend: str = "auto",
               precision: str = "exact",
               device: str | torch.device | None = None) -> np.ndarray:
    """Compressed bytes -> uint8 image (H, W).

    precision: "exact" (the float64 oracle's pixels) or "fast" (float32
    inverse transform; a pixel may differ by one level).
    """
    _check_backend(backend)
    with profiling.span("codec.decompress") as call:
        if backend == "host":
            return container.decompress(data)
        engine = Engine(precision, device)
        out = engine.decompress(data)
        call.set(**engine.decode_stats)
        return out


def decompress_batch(streams: list[bytes], backend: str = "auto",
                     precision: str = "exact",
                     device: str | torch.device | None = None):
    """Compressed streams -> decoded uint8 images.

    TICX-indexed uniform batches (standard tables, or one shared
    standard-range dynamic table) are entropy-decoded on the device, chunk
    by chunk in parallel; other streams are entropy-decoded on the host
    and transformed on the device.  Uniform batches return a stacked
    ``(B, H, W)`` array; mixed shapes are grouped into uniform runs and a
    list of (H, W) arrays comes back in input order.
    """
    _check_backend(backend)
    with profiling.span("codec.decompress_batch") as call:
        if backend == "host":
            out = [container.decompress(s) for s in streams]
            if len({o.shape for o in out}) > 1:
                return out
            return np.stack(out)
        engine = Engine(precision, device)
        out = engine.decompress_batch(streams)
        call.set(**engine.decode_stats)
        return out
