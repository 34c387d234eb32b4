"""tinyimgcodec_tpu_torch: the PyTorch/CUDA port of tinyimgcodec_tpu.

A grayscale JPEG-style codec (8x8 DCT -> quantize -> zig-zag -> DC DPCM ->
Annex K Huffman coding) whose encode and decode paths run on an NVIDIA
Hopper card through hand-written CUDA kernels (``csrc/``), with a C host
runtime (``native/``) for entropy decode on the host.  This package imports
``torch``, ``numpy`` and ``scipy`` only; it shares no code with the JAX
package, whose bytes it reproduces.

Public API:

- ``compress(image, quality) -> bytes`` (with
  ``auto_generate_huffman_table=True``: tables built for the image) and
  ``compress_batch(images, quality) -> list[bytes]``: on the card by
  default (``device=None``);
  without a card they raise unless ``device="cpu"`` or
  ``backend="host"`` is passed.
- ``decompress(data) -> image`` and ``decompress_batch(streams)``: the
  same device rule; TICX-indexed streams are entropy-decoded on the card.
- ``encode(image, quality) -> CodecArrays`` / ``decode(CodecArrays)``:
  the array-level host oracle.

``parallel`` spreads one image's block ranges or a batch's images over
the ranks of a ``torch.distributed`` group and streams images through a
double-buffered feed; ``jobs``, ``profiling`` and ``cli`` are the tools.
"""

from __future__ import annotations

from .constants import (
    AC,
    DC,
    EOB,
    LUMINANCE_QUANTIZATION_TABLE,
    ZIGZAG_ORDER,
    ZRL,
)
from .golden import CodecArrays
from .golden import decode_arrays as decode
from .golden import encode_arrays as encode
from .api import compress, compress_batch, decompress, decompress_batch
from .config import CodecConfig

__version__ = "0.1.0"

__all__ = [
    "encode",
    "decode",
    "compress",
    "compress_batch",
    "decompress",
    "decompress_batch",
    "CodecArrays",
    "CodecConfig",
    "LUMINANCE_QUANTIZATION_TABLE",
    "ZIGZAG_ORDER",
    "EOB",
    "ZRL",
    "DC",
    "AC",
    "__version__",
]
