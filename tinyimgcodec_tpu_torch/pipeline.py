"""The single-device encode layer: images -> TICX-ready streams.

The counterpart of the JAX package's ``pallas_pipeline.compress_batch_pallas``
on an NVIDIA card, and the one encode chain that every encode path of the
port runs on a device.  Per batch (``compress_batch_device``):

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

One image's consecutive blocks, in calls of at most ``MAX_PIXELS``
pixels (``sub_ranges``): coefficients a call (``range_coefficients``),
then ``encode2`` with the DC predictor carried from call to call and
``place`` (``encode_ranges``), the segments joined at int64 bit offsets
(``concat_bits``).  ``compress_image`` runs them over a whole image (the
path of an image over ``MAX_PIXELS``), the engine's auto-table encode
over the image with its own tables, and the mesh's shard body
(``tiled._encode``) over each shard's range.  ``frame_stream`` writes the
header, payload and TICX trailer of every stream of this layer and of
``tiled.encode_tiled``.  A range records the stages of
``compress_batch_device``: ``codec.encode.upload``, ``.transform`` (exact
mode), ``.entropy`` (``encode2``), ``.place`` and, with offsets, ``.pull``
(the blocks' offsets).

What is kept from the JAX pipeline, in behaviour: the capacity budget
``ceil(B*H*W*bits_per_pixel_budget / 32)`` words, the capacity flag and
the table-range flag (a coefficient outside the Huffman tables), one
retry at ``n * 52`` words on the first, ``ValueError`` on the second,
the true dimensions in the header for padded input.  What is gone: tile
sizes and the 128-lane rule (any block count >= 1 goes through the
kernels), the word-packed input layout and every fallback to another
backend.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import container, profiling
from .device import resolve_device
from .golden import CodecArrays
from .ops import transform
from .ops.encode1 import encode1
from .ops.encode2 import encode2, fast_coefficients
from .ops.exact_transform import exact_transform
from .ops.place import place
from .ops.stitch import stitch
from .tables import CodecTables

# One call of the kernels takes at most this many pixels: block bit
# offsets are int32 (safe up to ~82 MP of worst-case content).  A larger
# batch is cut into calls of whole images; a larger image is cut into
# block ranges of at most this many pixels (``sub_ranges``), each with its
# own int32 offsets, stitched at 64-bit bit offsets.
MAX_PIXELS = 16 << 20
_M32 = 0xFFFFFFFF


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
    cap_over)`` (``cap_over`` nonzero: the stream passed ``cap`` words) at
    ``cap_words``, once more at ``n * 52`` words (the worst case) if that
    was too small, one sync a run: (the stream words up to the total's
    last word, still on the device; image starts (B,); total bits; whether
    ``overflow`` says a coefficient lies outside the Huffman tables --
    then nothing is retried, and the caller decides whether to raise; the
    value of ``rider``, a 0-d int64 device tensor read in the same pull,
    or ``None``)."""
    extra = [] if rider is None else [rider]

    def run(cap):
        stream, starts, total, cap_over = launch(cap)
        head = torch.stack([cap_over.to(torch.int64),
                            overflow.to(torch.int64),
                            total.to(torch.int64), *extra]).cpu()
        return stream, starts, head.tolist()  # synced

    with profiling.span("codec.encode.place", retried=0) as stage:
        stream, starts, (cap_over, table_over, total, *ridden) = run(
            max(cap_words, 1))
        if cap_over and not table_over:
            stage.set(retried=1)
            stream, starts, (cap_over, table_over, total, *ridden) = run(
                n * 52)
            if cap_over:
                raise ValueError("stream capacity overflow (worst case!)")
    return (stream[: -(-total // 32)], starts, total, bool(table_over),
            ridden[0] if ridden else None)


def stream_bytes(words: torch.Tensor, total: int) -> bytes:
    """Stream words (int32 or int64 bit patterns, on any device) -> the
    big-endian bytes up to the ``total``-th bit's byte."""
    raw = words.cpu().numpy()
    raw = raw.view(np.uint32) if raw.dtype == np.int32 else raw
    return raw.astype(">u4").tobytes()[: -(-total // 8)]


def place_words(packed: torch.Tensor, meta: torch.Tensor,
                overflow: torch.Tensor, nb: int, cap_words: int):
    """``encode2``'s outputs -> the stream through ``place``, left on the
    device: (stream words, image starts, total bits, whether a
    coefficient lies outside the Huffman tables), as :func:`_assemble`
    returns them."""
    return _assemble(lambda cap: place(packed, meta, nb, cap), overflow,
                     packed.shape[0], cap_words)[:4]


@functools.lru_cache(maxsize=64)
def _stream_header(h: int, w: int, quality: int) -> bytes:
    # built once a shape: a batch frames every image with the same header
    return container.make_header(CodecArrays(
        height=h, width=w, quality=quality,
        dc=np.empty(0, np.int32), ac=np.empty((0, 63), np.int32),
    ))


def frame_stream(true_shape: tuple[int, int], quality: int, payload,
                 offsets: np.ndarray | None = None,
                 index_stride: int = container.INDEX_STRIDE) -> bytes:
    """One image's payload (bytes-like) -> its stream: the header with the
    true (H, W) and the quality, the payload and, given its blocks' bit
    offsets from the payload's start, its TICX trailer."""
    parts = [_stream_header(*true_shape, quality), payload]
    if offsets is not None:
        parts.append(container.make_block_index(offsets, stride=index_stride))
    return b"".join(parts)


def split_streams(raw: bytes, starts: np.ndarray, true_shape: tuple[int, int],
                  quality: int, offsets: np.ndarray | None = None,
                  index_stride: int = container.INDEX_STRIDE) -> list[bytes]:
    """A batch's stream bytes -> one stream an image
    (:func:`frame_stream`): the image's bytes from its byte-aligned start
    bit ``starts[i]`` and, given the batch's (N,) block bit ``offsets``,
    its TICX trailer."""
    view = memoryview(raw)
    nb = 0 if offsets is None else len(offsets) // len(starts)
    first = starts.tolist()
    ends = [s // 8 for s in first[1:]] + [len(raw)]
    return [frame_stream(true_shape, quality, view[s // 8:e],
                         None if offsets is None
                         else offsets[i * nb:(i + 1) * nb] - s,
                         index_stride)
            for i, (s, e) in enumerate(zip(first, ends))]


def sub_ranges(start: int, stop: int) -> list[tuple[int, int]]:
    """``[start, stop)`` cut into ranges of at most one call's blocks."""
    step = MAX_PIXELS // 64
    return [(a, min(stop, a + step)) for a in range(start, stop, step)]


def range_blocks(image, start: int, stop: int,
                 dev: torch.device) -> torch.Tensor:
    """Blocks ``[start, stop)`` of a block-aligned (H, W) uint8 image (a
    numpy array or a tensor) as (n, 64) uint8 on ``dev``: only the rows of
    blocks that hold them are moved."""
    wb = image.shape[1] // 8
    r0, r1 = start // wb, (stop - 1) // wb + 1
    rows = image[8 * r0:8 * r1]
    if isinstance(rows, torch.Tensor):
        rows = rows.to(dev)
    else:
        rows = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    blocks = transform.blockify(rows).reshape(-1, 64)
    return blocks[start - r0 * wb:stop - r0 * wb]


def range_coefficients(image, start: int, stop: int, tables: CodecTables,
                       precision: str,
                       dev: torch.device) -> list[torch.Tensor]:
    """The (64, n) int32 coefficients of every sub-range of ``[start,
    stop)``: exact ones equal the float64 oracle's."""
    out = []
    for a, b in sub_ranges(start, stop):
        with profiling.span("codec.encode.upload"):
            blocks = range_blocks(image, a, b, dev)
        if precision == transform.EXACT:
            out.append(exact_coefficients(blocks, tables))
        else:
            out.append(fast_coefficients(blocks, tables))
    return out


def encode_ranges(zz_list: list[torch.Tensor], tables: CodecTables,
                  dc_first: torch.Tensor | None,
                  bits_per_pixel_budget: float, with_offsets: bool = False):
    """Consecutive sub-ranges of one image -> one segment each through
    ``encode2`` (the DC predictor carried from range to range, the first
    from ``dc_first``, a (1,) int32 tensor or ``None`` for zero) and
    ``place``.  Returns ``(segments, offsets, table_overflow)``:
    ``[(stream words on the device, bits)]``, the blocks' bit offsets from
    the first segment's start as one int64 host array (or ``None``), and
    whether a coefficient lay outside the tables in any range."""
    segments, offsets, over, before = [], [], False, 0
    prev = dc_first
    for zz in zz_list:
        n = zz.shape[1]
        with profiling.span("codec.encode.entropy"):
            packed, meta, flag = encode2(zz, tables, n, from_zz=True,
                                         dc_init=prev)
        cap = -(-int(n * 64 * bits_per_pixel_budget) // 32)
        words, _, bits, table_over = place_words(packed, meta, flag, n, cap)
        over |= table_over
        segments.append((words, bits))
        if with_offsets:
            with profiling.span("codec.encode.pull"):
                offsets.append(meta[0].cpu().numpy().astype(np.int64)
                               + before)
        before += bits
        prev = zz[0, n - 1:]
    offs = np.concatenate(offsets) if with_offsets and offsets else None
    return segments, offs, over


def concat_bits(segments, device: torch.device) -> tuple[torch.Tensor, int]:
    """Segments ``[(words, bits)]`` (int32 or int64 big-endian bit
    patterns, zero past their bits) -> one stream of int64 words on
    ``device`` and its bits; segment i starts at the sum of the bits
    before it, an int64 bit offset."""
    total = sum(bits for _, bits in segments)
    out = torch.zeros(-(-total // 32) + 1, dtype=torch.int64, device=device)
    at = 0
    for words, bits in segments:
        k = -(-bits // 32)
        if k:
            v = words[:k].to(device=device, dtype=torch.int64) & _M32
            base, sh = at >> 5, at & 31
            out[base:base + k] += v >> sh  # disjoint bits: ADD == OR
            if sh:
                out[base + 1:base + k + 1] += (v << (32 - sh)) & _M32
        at += bits
    return out[:-(-total // 32)], total


def compress_image(image, true_shape: tuple[int, int], quality: int,
                   precision: str, block_index: bool, index_stride: int,
                   bits_per_pixel_budget: float, dev: torch.device) -> bytes:
    """One block-aligned image (numpy or a tensor) on ``dev``, in
    sub-ranges (:func:`sub_ranges`), assembled on the host: the stream
    ``compress_batch_device`` writes for an image of more than
    ``MAX_PIXELS`` pixels, TICX trailer included when asked for."""
    nb = (image.shape[0] // 8) * (image.shape[1] // 8)
    tables = CodecTables.build(quality, dev)
    segments, offsets, table_over = encode_ranges(
        range_coefficients(image, 0, nb, tables, precision, dev), tables,
        None, bits_per_pixel_budget, with_offsets=block_index)
    if table_over:
        raise TableRangeError()
    words, bits = concat_bits(segments, torch.device("cpu"))
    return frame_stream(true_shape, quality, stream_bytes(words, bits),
                        offsets, index_stride)


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
    alone, in block ranges (:func:`compress_image`); only the
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

    launch = ((lambda cap: place(packed, meta, nb, cap)) if meta is not None
              else lambda cap: stitch(words, bits, nb, cap))
    stream, starts, total, table_over, flagged = _assemble(
        launch, overflow, n, cap_words, flagged)
    if table_over:
        raise TableRangeError()
    if flagged is not None:
        stage.set(flagged=flagged)
    with profiling.span("codec.encode.pull"):
        raw = stream_bytes(stream, total)
        starts = starts.cpu().numpy().astype(np.int64)
        off_all = (meta[0].cpu().numpy().astype(np.int64) if block_index
                   else None)
    with profiling.span("codec.encode.assemble"):
        return split_streams(raw, starts, (th, tw), quality, off_all,
                             index_stride)
