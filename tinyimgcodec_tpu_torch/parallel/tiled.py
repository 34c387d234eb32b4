"""One image encoded in block ranges, over the shards of a mesh.

The counterpart of the JAX package's ``parallel/tiled.py`` (BASELINE
config 4: a 4K+ image tiled across devices).  A shard is a card of this
process (the default mesh: every visible card), a rank of a process
group, or one of several cards in each process of a group
(``parallel.mesh``).  Design:

- the image's 8x8 blocks, in raster order, are split into one contiguous
  range a shard (``ceil(nb / n)`` blocks each; when ``nb < n`` the
  last shards get none, launch nothing and add an empty segment);
- within a shard the range is cut again into sub-ranges of at most
  ``pipeline.MAX_PIXELS // 64`` blocks, one call of the kernels each, so
  that every call keeps its block bit offsets in int32 (on one card this
  cut alone is what lets an image pass ``MAX_PIXELS``);
- a sub-range is ``exact_coefficients`` (exact) or ``fast_coefficients``
  (fast), then ``encode2(..., from_zz=True, dc_init=...)`` and ``place``
  as one image: the DC predictor of its first block is the last DC of
  the sub-range before it, which stays on the device; across shards it
  is an ``all_gather`` of every shard's last DC (the JAX ``ppermute``),
  shard r taking shard r - 1's and shard 0 zero;
- segments are stitched at bit offsets, not byte offsets (the image
  starts once), computed in int64: ``assemble="host"`` pulls them to the
  host and concatenates them there; ``assemble="device"`` concatenates on
  the card (local shard 0's, in a local mesh).  Across shards, the
  lengths and then the segments are all-gathered and concatenated in
  shard order, on every rank of a process group (every rank returns the
  stream) and on local shard 0 of a local mesh, in each process of a
  group (whose result is returned).  The concatenation
  is plain torch (one vectorised shift a segment), as the JAX package's
  was XLA.

Exact mode gives the float64 oracle's bytes in both assembly modes (the
port's exact coefficients always equal the oracle's).  A stream over the
capacity budget is placed again at ``n * 52`` words; a coefficient
outside the Huffman tables raises ``ValueError`` on every shard.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import container, pipeline
from ..golden import CodecArrays
from ..ops import transform
from ..ops.encode2 import encode2, fast_coefficients
from ..tables import CodecTables
from .mesh import Mesh, make_mesh

_M32 = 0xFFFFFFFF


def block_range(nb: int, world: int, rank: int) -> tuple[int, int]:
    """The blocks ``[start, stop)`` of ``rank``: ``ceil(nb / world)``
    each, the last ranks fewer or none."""
    per = -(-nb // world)
    return min(nb, rank * per), min(nb, (rank + 1) * per)


def sub_ranges(start: int, stop: int) -> list[tuple[int, int]]:
    """``[start, stop)`` cut into ranges of at most one call's blocks."""
    step = pipeline.MAX_PIXELS // 64
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
        blocks = range_blocks(image, a, b, dev)
        if precision == transform.EXACT:
            out.append(pipeline.exact_coefficients(blocks, tables))
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
    whether a coefficient lay outside the tables."""
    segments, offsets, over, before = [], [], False, 0
    prev = dc_first
    for zz in zz_list:
        n = zz.shape[1]
        packed, meta, flag = encode2(zz, tables, n, from_zz=True,
                                     dc_init=prev)
        cap = -(-int(n * 64 * bits_per_pixel_budget) // 32)
        words, _, bits, table_over = pipeline.place_words(packed, meta, flag,
                                                          n, cap)
        over |= table_over
        segments.append((words, bits))
        if with_offsets:
            offsets.append(meta[0].cpu().numpy().astype(np.int64) + before)
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


def _header(h: int, w: int, quality: int) -> bytes:
    return container.make_header(CodecArrays(
        height=h, width=w, quality=quality,
        dc=np.empty(0, np.int32), ac=np.empty((0, 63), np.int32),
    ))


def _encode(mesh: Mesh, image, quality: int, precision: str, assemble: str,
            bits_per_pixel_budget: float, with_offsets: bool = False):
    """A block-aligned image -> (payload bytes, this shard's block offsets
    from its range's start or ``None``); the same payload on every shard
    whose result is wanted (``None`` on the others)."""
    dev = mesh.device
    nb = (image.shape[0] // 8) * (image.shape[1] // 8)
    start, stop = block_range(nb, mesh.size, mesh.rank)
    tables = CodecTables.build(quality, dev)
    zz_list = range_coefficients(image, start, stop, tables, precision,
                                 dev)
    dc_first = None
    if mesh.size > 1:
        last = (zz_list[-1][0, -1:] if zz_list
                else torch.zeros(1, dtype=torch.int32, device=dev))
        lasts = mesh.all_gather(last.to(torch.int64))
        if mesh.rank > 0:
            dc_first = lasts[mesh.rank - 1].to(dev, torch.int32)
    segments, offsets, table_over = encode_ranges(
        zz_list, tables, dc_first, bits_per_pixel_budget, with_offsets)
    if mesh.any(table_over):
        raise pipeline.TableRangeError()
    where = dev if assemble == "device" else torch.device("cpu")
    words, bits = concat_bits(segments, where)
    if mesh.size > 1:
        all_bits = mesh.all_gather(torch.tensor([bits], dtype=torch.int64))
        all_words = mesh.all_gather_varlen(words)
        if not mesh.result_wanted:
            return None, offsets
        words, bits = concat_bits(
            [(w, int(b)) for w, b in zip(all_words, all_bits)], where)
    return pipeline.stream_bytes(words, bits), offsets


def encode_tiled(
    image: np.ndarray,
    quality: int = 50,
    mesh: Mesh | None = None,
    precision: str = transform.EXACT,
    assemble: str = "host",
    bits_per_pixel_budget: float = 6.0,
    device: str | torch.device | None = None,
) -> bytes:
    """Encode one (H, W) uint8 image block-range-sharded over ``mesh``'s
    shards (``None``: :func:`make_mesh` -- every visible card, as the JAX
    function's mesh over ``jax.devices()``, or a world of one on
    ``device`` when that is given).  The stream comes back (on every rank
    of a process group, each of which passes the image): header +
    payload, no trailer -- the bytes of the JAX package's
    ``encode_tiled``, and in exact mode of ``container.compress``."""
    if assemble not in ("host", "device"):
        raise ValueError(f"unknown assemble mode {assemble!r}")
    if precision not in (transform.FAST, transform.EXACT):
        raise ValueError(f"unknown precision {precision!r}")
    if mesh is None:
        mesh = make_mesh(device=device)
    image = np.asarray(image)
    if image.ndim != 2 or min(image.shape) < 1:
        raise ValueError("expected a non-empty 2-D grayscale image")
    h, w = image.shape
    padded = np.ascontiguousarray(
        transform.pad_to_blocks(image.astype(np.uint8, copy=False)))
    payload, _ = mesh.run(_encode, padded, int(quality), precision,
                          assemble, bits_per_pixel_budget)
    return _header(h, w, int(quality)) + payload


def compress_image(image, true_shape: tuple[int, int], quality: int,
                   precision: str, block_index: bool, index_stride: int,
                   bits_per_pixel_budget: float, dev: torch.device) -> bytes:
    """One block-aligned image (numpy or a tensor) on one device, in
    sub-ranges, host assembly: the stream ``compress_batch_device`` writes
    for an image of more than ``MAX_PIXELS`` pixels, TICX trailer
    included when asked for."""
    payload, offsets = _encode(Mesh(None, 1, 0, dev), image, quality,
                               precision, "host", bits_per_pixel_budget,
                               with_offsets=block_index)
    data = _header(*true_shape, quality) + payload
    if block_index:
        data += container.make_block_index(offsets, stride=index_stride)
    return data
