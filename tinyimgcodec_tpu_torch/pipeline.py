"""Batch encode pipeline: image batch -> one TICX-ready stream per image.

The counterpart of the JAX package's ``pallas_pipeline.compress_batch_pallas``
on an NVIDIA card.  Per batch:

- fast:  pixels -> [encode2: float32 transform + entropy] -> [place]
  (``version="v2"``, the default), or pixels -> [encode1: the same
  transform and symbols, each block packed from bit 0 of its own row] ->
  [stitch: look-back scan + funnel-shift gather] (``version="v1"``, the JAX
  package's comparison path; same bytes)
- exact: pixels -> [exact_transform: float64 on the tensor cores, the
  tie-flagged blocks settled in the oracle's own arithmetic inside the
  same kernel] -> [encode2 from coefficients] -> [place]

followed by one pull of the stream words, image starts, total and status
(and, in exact mode, the count of flagged blocks with them), and
per-image slicing at the byte-aligned image starts.  Exact-mode bytes
equal ``container.compress(..., block_index=...)``, the float64 host
oracle.  Each stage is a ``codec.encode.*`` span of ``profiling.span``.

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

from . import container, profiling
from .device import resolve_device
from .golden import CodecArrays
from .ops import transform
from .ops.encode1 import encode1
from .ops.encode2 import encode2
from .ops.exact_transform import exact_transform
from .ops.place import place
from .ops.stitch import stitch
from .tables import CodecTables

# One call of the kernels takes at most this many pixels: block bit
# offsets are int32 (safe up to ~82 MP of worst-case content).  A larger
# batch is cut into calls of whole images; a larger image is cut into
# block ranges of at most this many pixels (``parallel/tiled.py``), each
# with its own int32 offsets, stitched at 64-bit bit offsets.
MAX_PIXELS = 16 << 20


class TableRangeError(ValueError):
    """A coefficient lies outside the Huffman tables, so no stream can be
    written (the oracle refuses the image too)."""

    def __init__(self, msg: str = "coefficient out of Huffman table range"):
        super().__init__(msg)


def exact_coefficients(blocks: torch.Tensor,
                       tables: CodecTables) -> torch.Tensor:
    """(N, 64) uint8 blocks -> (64, N) int32 coefficients equal to the
    float64 oracle's, on the blocks' device, with no host sync:
    ``exact_transform`` settles its tie-flagged blocks itself."""
    with profiling.span("codec.encode.transform"):
        return exact_transform(blocks, tables)[0]


def check_pixels(h: int, w: int) -> None:
    """Refuse an image of more than ``MAX_PIXELS`` pixels (block-aligned)
    on a path that cannot cut it: the v1 kernels carry no DC predictor
    into a block range."""
    if h * w > MAX_PIXELS:
        raise NotImplementedError(
            f"an image of {h * w} pixels exceeds the {MAX_PIXELS}-pixel "
            "limit of one call of the v1 kernels, which cannot cut an "
            "image into block ranges; the v2 kernels (version='v2') can"
        )


def _assemble(launch, overflow: torch.Tensor, n: int, cap_words: int,
              rider: torch.Tensor | None = None):
    """Run the stream assembly ``launch(cap) -> (stream, starts, total,
    status)`` (status bit 2: the stream passed ``cap`` words) at
    ``cap_words``, once more at ``n * 52`` words (the worst case) if that
    was too small: (the stream words up to the total's last word, still
    on the device; image starts (B,); total bits; whether ``overflow``
    says a coefficient lies outside the Huffman tables -- then nothing is
    retried; the value of ``rider``, a 0-d int64 device tensor read in
    the same pull as the status, or ``None``)."""
    extra = [] if rider is None else [rider]

    def run(cap):
        stream, starts, total, status = launch(cap)
        status = status.to(torch.int64) + overflow.to(torch.int64) * 4
        head = torch.stack([status, total.to(torch.int64), *extra]).cpu()
        return stream, starts, int(head[1]), int(head[0]), head  # synced

    with profiling.span("codec.encode.place", retried=0) as stage:
        stream, starts, total, status, head = run(max(cap_words, 1))
        if status & 2 and not status & 4:
            stage.set(retried=1)
            stream, starts, total, status, head = run(n * 52)
            if status & 2:
                raise ValueError("stream capacity overflow (worst case!)")
    return (stream[: -(-total // 32)], starts, total, bool(status & 4),
            int(head[2]) if extra else None)


def stream_bytes(words: torch.Tensor, total: int) -> bytes:
    """Stream words (int32 or int64 bit patterns, on any device) -> the
    big-endian bytes up to the ``total``-th bit's byte."""
    raw = words.cpu().numpy()
    raw = raw.view(np.uint32) if raw.dtype == np.int32 else raw
    return raw.astype(">u4").tobytes()[: -(-total // 8)]


def _assemble_checked(launch, overflow: torch.Tensor, n: int,
                      cap_words: int, rider: torch.Tensor | None = None):
    """:func:`_assemble`, raising :class:`TableRangeError` when a
    coefficient lies outside the Huffman tables: (stream words on the
    device, image starts (B,) on the device, total bits, the value of
    ``rider`` or ``None``)."""
    stream, starts, total, table_over, ridden = _assemble(
        launch, overflow, n, cap_words, rider)
    if table_over:
        raise TableRangeError()
    return stream, starts, total, ridden


def _pull(stream: torch.Tensor, starts: torch.Tensor, total: int):
    """The stream and its image starts to the host: (big-endian stream
    bytes up to the total's last byte, image starts (B,) int64)."""
    return stream_bytes(stream, total), starts.cpu().numpy().astype(np.int64)


def _place_launch(packed: torch.Tensor, meta: torch.Tensor, nb: int):
    def launch(cap):
        stream, starts, total, cap_over = place(packed, meta, nb, cap)
        return stream, starts, total, cap_over.to(torch.int64) * 2

    return launch


def place_words(packed: torch.Tensor, meta: torch.Tensor,
                overflow: torch.Tensor, nb: int, cap_words: int):
    """``encode2``'s outputs -> the stream through ``place``, left on the
    device: (stream words, image starts, total bits, whether a
    coefficient lies outside the Huffman tables), as :func:`_assemble`
    returns them."""
    return _assemble(_place_launch(packed, meta, nb), overflow,
                     packed.shape[0], cap_words)[:4]


def place_stream(packed: torch.Tensor, meta: torch.Tensor,
                 overflow: torch.Tensor, nb: int, cap_words: int):
    """``encode2``'s outputs -> the stream through ``place``, pulled:
    (big-endian stream bytes up to the total's last byte, image starts
    (B,) int64, total bits).  Raises ``TableRangeError`` when a
    coefficient lies outside the Huffman tables."""
    stream, starts, total, _ = _assemble_checked(
        _place_launch(packed, meta, nb), overflow, packed.shape[0],
        cap_words)
    return (*_pull(stream, starts, total), total)


def split_streams(raw: bytes, starts: np.ndarray, true_shape: tuple[int, int],
                  quality: int, offsets: np.ndarray | None = None,
                  index_stride: int = container.INDEX_STRIDE) -> list[bytes]:
    """A batch's stream bytes -> one stream an image: the header with the
    true (H, W), the image's bytes from its byte-aligned start bit
    ``starts[i]`` and, given the batch's (N,) block bit ``offsets``, its
    TICX trailer."""
    th, tw = true_shape
    header = container.make_header(
        CodecArrays(
            height=th, width=tw, quality=quality,
            dc=np.empty(0, np.int32), ac=np.empty((0, 63), np.int32),
        )
    )
    b = len(starts)
    nb = 0 if offsets is None else len(offsets) // b
    out = []
    for i in range(b):
        s = int(starts[i]) // 8
        e = int(starts[i + 1]) // 8 if i + 1 < b else len(raw)
        data = header + raw[s:e]
        if offsets is not None:
            data += container.make_block_index(
                offsets[i * nb : (i + 1) * nb] - int(starts[i]),
                stride=index_stride,
            )
        out.append(data)
    return out


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

    An image of more than ``MAX_PIXELS`` (block-aligned) pixels is encoded
    alone, in block ranges (``parallel.tiled.compress_image``); only the
    v1 kernels, which carry no DC predictor in, refuse it.  A list of
    images of several shapes is encoded one run of equal shapes at a time.
    """
    dev = resolve_device(device)
    if precision not in (transform.FAST, transform.EXACT):
        raise ValueError(f"unknown precision {precision!r}")
    if version not in ("v1", "v2"):
        raise ValueError(f"unknown version {version!r}")
    if block_index and version != "v2":
        raise ValueError("block_index requires the v2 kernels")
    kw = dict(precision=precision, block_index=block_index,
              index_stride=index_stride, device=dev, version=version)
    if (isinstance(images, (list, tuple)) and true_shape is None
            and len({np.shape(im) for im in images}) > 1):
        # images of several shapes: each run of one shape is a batch
        out: list[bytes] = []
        start = 0
        for i in range(1, len(images) + 1):
            if (i == len(images)
                    or np.shape(images[i]) != np.shape(images[start])):
                out += compress_batch_device(
                    np.stack(images[start:i]), quality,
                    bits_per_pixel_budget, **kw)
                start = i
        return out
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
    else:
        images = np.ascontiguousarray(np.asarray(images), dtype=np.uint8)
        if images.ndim != 3:
            raise ValueError("expected a (B, H, W) batch")
        b, th, tw = images.shape
        if true_shape is not None:
            th, tw = true_shape
        images = np.ascontiguousarray(transform.pad_to_blocks(images))
        b, h, w = images.shape
    if b < 1 or h < 8 or w < 8:
        raise ValueError(f"empty batch or image ({b}x{h}x{w})")
    if h * w > MAX_PIXELS and version == "v2":
        # each image alone, in block ranges that carry the DC predictor
        from .parallel.tiled import compress_image

        return [compress_image(im, (th, tw), int(quality), precision,
                               block_index, index_stride,
                               bits_per_pixel_budget, dev)
                for im in images]
    check_pixels(h, w)
    per = MAX_PIXELS // (h * w)
    if b > per:
        # images are self-contained streams: calls of at most ``per``
        # images each give the same bytes as one call would
        return [
            data for i in range(0, b, per)
            for data in compress_batch_device(
                images[i:i + per], quality, bits_per_pixel_budget,
                true_shape=(th, tw), **kw)
        ]
    quality = int(quality)
    nb = (h // 8) * (w // 8)
    n = b * nb
    cap_words = -(-int(b * h * w * bits_per_pixel_budget) // 32)

    if isinstance(images, np.ndarray):
        images = torch.from_numpy(images)
    with profiling.span("codec.encode.upload"):
        tables = CodecTables.build(quality, dev)
        blocks = transform.blockify(images.to(dev)).reshape(n, 64)
    meta = flagged = None
    if precision == transform.EXACT:
        # the count of flagged blocks rides the status pull of the assembly
        with profiling.span("codec.encode.transform") as stage:
            zz, _, flagged = exact_transform(blocks, tables)
    with profiling.span("codec.encode.entropy") as entropy:
        if precision == transform.EXACT:
            packed, meta, overflow = encode2(zz, tables, nb, from_zz=True)
        else:
            # fast: the entropy kernel runs the transform on the pixels
            entropy.set(from_pixels=n)
            if version == "v2":
                packed, meta, overflow = encode2(blocks, tables, nb)
            else:
                words, bits, overflow = encode1(blocks, tables, nb)

    launch = (_place_launch(packed, meta, nb) if meta is not None
              else lambda cap: stitch(words, bits, nb, cap))
    stream, starts, total, flagged = _assemble_checked(
        launch, overflow, n, cap_words, flagged)
    if flagged is not None:
        stage.set(flagged=flagged)
    with profiling.span("codec.encode.pull"):
        raw, starts = _pull(stream, starts, total)
        off_all = (meta[0].cpu().numpy().astype(np.int64) if block_index
                   else None)
    with profiling.span("codec.encode.assemble"):
        return split_streams(raw, starts, (th, tw), quality, off_all,
                             index_stride)
