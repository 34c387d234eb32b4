"""One image's block ranges sharded over a mesh.

The counterpart of the JAX package's ``parallel/tiled.py`` (BASELINE
config 4: a 4K+ image tiled across devices).  A shard is a card of this
process (the default mesh: every visible card), a rank of a process
group, or one of several cards in each process of a group
(``parallel.mesh``).  The image's 8x8 blocks, in raster order, are split
into one contiguous range a shard (``ceil(nb / n)`` blocks each; when
``nb < n`` the last shards get none, launch nothing and add an empty
segment).  Each shard encodes its range through the pipeline's block
ranges (``pipeline.range_coefficients``, ``pipeline.encode_ranges``),
its first DC predictor the last DC of the shard before it, from an
``all_gather`` of every shard's last DC (the JAX ``ppermute``; shard 0
starts from zero).  The shards agree on a table refusal with
``mesh.any`` before any raises, so a coefficient outside the Huffman
tables raises ``ValueError`` on every shard.  The segments are joined at
int64 bit offsets by ``pipeline.concat_bits``: ``assemble="host"`` on
the host, ``assemble="device"`` on the card (local shard 0's, in a local
mesh); across shards the lengths and then the segments are
all-gathered and joined in shard order, on every rank of a process
group (every rank returns the stream) and on local shard 0 of a local
mesh, in each process of a group (whose result is returned).

Exact mode gives the float64 oracle's bytes in both assembly modes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import pipeline
from ..ops import transform
from ..tables import CodecTables
from .mesh import Mesh, make_mesh


def block_range(nb: int, world: int, rank: int) -> tuple[int, int]:
    """The blocks ``[start, stop)`` of ``rank``: ``ceil(nb / world)``
    each, the last ranks fewer or none."""
    per = -(-nb // world)
    return min(nb, rank * per), min(nb, (rank + 1) * per)


def _encode(mesh: Mesh, image, quality: int, precision: str, assemble: str,
            bits_per_pixel_budget: float):
    """A block-aligned image -> its payload bytes on every shard whose
    result is wanted (``None`` on the others)."""
    dev = mesh.device
    nb = (image.shape[0] // 8) * (image.shape[1] // 8)
    start, stop = block_range(nb, mesh.size, mesh.rank)
    tables = CodecTables.build(quality, dev)
    zz_list = pipeline.range_coefficients(image, start, stop, tables,
                                          precision, dev)
    dc_first = None
    if mesh.size > 1:
        last = (zz_list[-1][0, -1:] if zz_list
                else torch.zeros(1, dtype=torch.int32, device=dev))
        lasts = mesh.all_gather(last.to(torch.int64))
        if mesh.rank > 0:
            dc_first = lasts[mesh.rank - 1].to(dev, torch.int32)
    segments, _, table_over = pipeline.encode_ranges(
        zz_list, tables, dc_first, bits_per_pixel_budget)
    if mesh.any(table_over):
        raise pipeline.TableRangeError()
    where = dev if assemble == "device" else torch.device("cpu")
    words, bits = pipeline.concat_bits(segments, where)
    if mesh.size > 1:
        all_bits = mesh.all_gather(torch.tensor([bits], dtype=torch.int64))
        all_words = mesh.all_gather_varlen(words)
        if not mesh.result_wanted:
            return None
        words, bits = pipeline.concat_bits(
            [(w, int(b)) for w, b in zip(all_words, all_bits)], where)
    return pipeline.stream_bytes(words, bits)


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
    padded = np.ascontiguousarray(
        transform.pad_to_blocks(image.astype(np.uint8, copy=False)))
    payload = mesh.run(_encode, padded, int(quality), precision, assemble,
                       bits_per_pixel_budget)
    return pipeline.frame_stream(image.shape, int(quality), payload)
