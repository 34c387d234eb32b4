"""Batch encode pipeline: image batch -> one TICX-ready stream per image.

The counterpart of the JAX package's ``pallas_pipeline.compress_batch_pallas``
on an NVIDIA card.  Per batch:

- fast:  pixels -> [encode2: float32 transform + entropy] -> [place]
  (``version="v2"``, the default), or pixels -> [encode1: the same
  transform and symbols, each block packed from bit 0 of its own row] ->
  [stitch: look-back scan + funnel-shift gather] (``version="v1"``, the JAX
  package's comparison path; same bytes)
- exact: pixels -> [exact_transform: float64 on the tensor cores + tie
  flags] -> host float64 recompute of the flagged blocks (one host sync)
  -> [encode2 from coefficients] -> [place]

followed by one pull of the stream words, image starts, total and status,
and per-image slicing at the byte-aligned image starts.  Exact-mode bytes
equal ``container.compress(..., block_index=...)``, the float64 host
oracle.

What is kept from the JAX pipeline, in behaviour: the capacity budget
``ceil(B*H*W*bits_per_pixel_budget / 32)`` words, status bit 2 (capacity)
and 4 (coefficient outside the Huffman tables), one retry at ``n * 52``
words on 2, ``ValueError`` on 4, the true dimensions in the header for
padded input.  What is gone: tile sizes and the 128-lane rule (any block
count >= 1 goes through the kernels), the word-packed input layout and
every fallback to another backend.
"""

from __future__ import annotations

import numpy as np
import torch

from . import container, golden
from .constants import ZIGZAG_ORDER
from .device import resolve_device
from .golden import CodecArrays
from .ops import transform
from .ops.encode1 import encode1
from .ops.encode2 import encode2
from .ops.exact_transform import exact_transform
from .ops.place import place
from .ops.stitch import stitch
from .tables import CodecTables

# Batches above this many pixels are not taken: block bit offsets are
# int32 (safe up to ~82 MP of worst-case content) and the JAX package
# routes such input to its tiled path, which is not ported yet.
MAX_PIXELS = 16 << 20


def _host_zz64(pixel_rows: np.ndarray, quality: int) -> np.ndarray:
    """(k, 64) pixel rows -> (k, 64) float64-quantized zig-zag rows: the
    oracle's arithmetic, used to settle tie-flagged blocks."""
    coeffs = golden.quantize(
        golden.block_dct(
            pixel_rows.reshape(-1, 8, 8).astype(np.float64) - 128.0
        ),
        quality,
    )
    return coeffs.reshape(-1, 64)[:, ZIGZAG_ORDER]


def exact_coefficients(blocks: torch.Tensor, quality: int,
                       tables: CodecTables) -> torch.Tensor:
    """(N, 64) uint8 blocks -> (64, N) int32 coefficients equal to the
    float64 oracle's: device transform, then the flagged blocks (roundings
    within 1e-9 of a tie) are recomputed on the host and patched in."""
    zz, flags = exact_transform(blocks, tables)
    idx = torch.nonzero(flags).reshape(-1)  # host sync: the count
    if idx.numel():
        pix = blocks[idx].cpu().numpy()
        fixed = _host_zz64(pix, quality).astype(np.int32)
        zz[:, idx] = torch.from_numpy(fixed.T.copy()).to(zz.device)
    return zz


def compress_batch_device(
    images,
    quality: int = 50,
    bits_per_pixel_budget: float = 4.0,
    precision: str = transform.FAST,
    block_index: bool = False,
    index_stride: int = container.INDEX_STRIDE,
    true_shape: tuple[int, int] | None = None,
    device: str | torch.device | None = None,
    version: str = "v2",
) -> list[bytes]:
    """(B, H, W) uint8 same-shaped images -> list of compressed bytes.

    ``images``: a numpy array (odd shapes are reflect-padded to block
    multiples here; the header records the true dimensions) or a
    ``torch.Tensor`` that is already block-aligned, typically on the card
    (``true_shape`` then gives the dimensions for the header).
    ``device``: ``None`` = the CUDA card, and a ``RuntimeError`` when
    there is none; ``"cpu"`` runs the kernels' plain versions.
    ``version``: ``"v2"`` (encode2 + place) or ``"v1"`` (encode1 +
    stitch), fast mode only: exact mode always runs the v2 kernels.  The
    block index needs the per-block offsets that only v2 returns.
    """
    dev = resolve_device(device)
    if precision not in (transform.FAST, transform.EXACT):
        raise ValueError(f"unknown precision {precision!r}")
    if version not in ("v1", "v2"):
        raise ValueError(f"unknown version {version!r}")
    if block_index and version != "v2":
        raise ValueError("block_index requires the v2 kernels")
    if isinstance(images, torch.Tensor):
        if images.dtype != torch.uint8 or images.ndim != 3:
            raise ValueError("expected a (B, H, W) uint8 tensor")
        b, h, w = images.shape
        if h % 8 or w % 8:
            raise ValueError(
                f"tensor batches must be block-aligned (got {h}x{w}); pad "
                "with ops.transform.pad_to_blocks or pass a numpy array"
            )
        th, tw = true_shape if true_shape is not None else (h, w)
        dev_images = images.to(dev)
    else:
        images = np.ascontiguousarray(np.asarray(images), dtype=np.uint8)
        if images.ndim != 3:
            raise ValueError("expected a (B, H, W) batch")
        b, th, tw = images.shape
        if true_shape is not None:
            th, tw = true_shape
        images = transform.pad_to_blocks(images)
        b, h, w = images.shape
        dev_images = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    if b < 1 or h < 8 or w < 8:
        raise ValueError(f"empty batch or image ({b}x{h}x{w})")
    if b * h * w > MAX_PIXELS:
        raise NotImplementedError(
            f"batch of {b * h * w} pixels exceeds the {MAX_PIXELS}-pixel "
            "limit of this encode path; larger input waits for the "
            "tiled/sharded slice of the port (parallel/)"
        )
    quality = int(quality)
    nb = (h // 8) * (w // 8)
    n = b * nb
    cap_words = -(-int(b * h * w * bits_per_pixel_budget) // 32)

    tables = CodecTables.build(quality, dev)
    blocks = transform.blockify(dev_images).reshape(n, 64)
    meta = None
    if precision == transform.EXACT:
        zz = exact_coefficients(blocks, quality, tables)
        packed, meta, overflow = encode2(zz, tables, nb, from_zz=True)
    elif version == "v2":
        packed, meta, overflow = encode2(blocks, tables, nb)
    else:
        words, bits, overflow = encode1(blocks, tables, nb)

    def run(cap):
        if meta is not None:
            stream, starts, total, cap_over = place(packed, meta, nb, cap)
            status = cap_over.to(torch.int64) * 2
        else:
            stream, starts, total, status = stitch(words, bits, nb, cap)
        status = status.to(torch.int64) + overflow.to(torch.int64) * 4
        head = torch.stack([status, total.to(torch.int64)]).cpu()  # sync
        return stream, starts, int(head[1]), int(head[0])

    stream, starts, total, status = run(max(cap_words, 1))
    if status & (2 | 4):
        if status & 4:
            raise ValueError("coefficient out of Huffman table range")
        # capacity overflow: retry once with the worst case
        stream, starts, total, status = run(n * 52)
        if status & 2:
            raise ValueError("stream capacity overflow (worst case!)")

    header = container.make_header(
        CodecArrays(
            height=th, width=tw, quality=quality,
            dc=np.empty(0, np.int32), ac=np.empty((0, 63), np.int32),
        )
    )
    nwords = -(-total // 32)
    raw = (
        stream[:nwords].cpu().numpy().view(np.uint32).astype(">u4").tobytes()
    )
    starts = starts.cpu().numpy().astype(np.int64)
    off_all = meta[0].cpu().numpy().astype(np.int64) if block_index else None
    out = []
    for i in range(b):
        s = int(starts[i]) // 8
        e = int(starts[i + 1]) // 8 if i + 1 < b else -(-total // 8)
        data = header + raw[s:e]
        if off_all is not None:
            data += container.make_block_index(
                off_all[i * nb : (i + 1) * nb] - int(starts[i]),
                stride=index_stride,
            )
        out.append(data)
    return out
