"""Single-image engine (encode side).

The counterpart of the encode half of the JAX package's ``engine.Engine``:
``compress`` runs the batch pipeline with B = 1, so the one-image entry
point and the batch entry point are the same program.  Decode on the
device is a later slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from . import container
from .device import resolve_device
from .ops import transform
from .pipeline import compress_batch_device


class Engine:
    """Holds the precision and the device the codec runs on.

    ``device=None`` is the CUDA card; constructing an engine without one
    raises ``RuntimeError`` (pass ``device="cpu"`` to run the plain
    versions of the kernels, as the tests do).
    """

    def __init__(self, precision: str = transform.EXACT,
                 device: str | torch.device | None = None):
        if precision not in (transform.EXACT, transform.FAST):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.device = resolve_device(device)

    def compress(
        self, image: np.ndarray, quality: int = 50,
        auto_table: bool = False, block_index: bool | None = None,
        index_stride: int = container.INDEX_STRIDE,
    ) -> bytes:
        image = np.asarray(image)
        if image.ndim != 2:
            raise ValueError("expected a 2-D grayscale image")
        if block_index is None:
            block_index = True
        if auto_table:
            raise NotImplementedError(
                "dynamic Huffman tables on the device wait for the "
                "auto-table encode slice of the port; use backend='host'"
            )
        # odd shapes are reflect-padded inside; the header keeps (H, W)
        return compress_batch_device(
            image[None], quality, precision=self.precision,
            block_index=block_index, index_stride=index_stride,
            device=self.device,
        )[0]
