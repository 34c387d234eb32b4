"""Data-parallel batches: images split over the shards of a mesh.

The counterpart of the JAX package's ``parallel/batch.py``.  Each image is
a self-contained stream, so nothing is carried across shards: the batch is
split into one group of ``ceil(B / n)`` consecutive images a shard (the
last group padded with repeats of the last image, so every shard runs the
same shapes), each shard runs the port's pipeline on its group on its own
device -- ``exact_transform`` (exact, its tie-flagged blocks settled on
the device in the oracle's arithmetic), ``encode2`` and ``place``, or the
decode kernel -- and
the results are all-gathered in the caller's order, the padding dropped.
A shard is a card of this process (the default mesh: every visible card),
a rank of a process group, or one of several cards in each process of a
group (``parallel.mesh``).

Exact mode gives the float64 oracle's bytes whatever the world size.  Not
carried over from the JAX package: its XLA batch programs
(``_batch_body``, ``_stream_body``; the port's kernels replace them) and
the 128-lane "not tileable" refusal, a TPU rule.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import container, profiling
from ..engine import Engine
from ..ops import transform
from ..ops.entropy_decode import prepare_batch
from ..pipeline import TableRangeError, compress_batch_device
from .mesh import Mesh, make_mesh


def _group(b: int, size: int, rank: int) -> list[int]:
    """The batch indices of shard ``rank`` of ``size``: ``ceil(b / size)``
    of them, those past the batch repeating its last image."""
    per = -(-b // size)
    return [min(i, b - 1) for i in range(rank * per, (rank + 1) * per)]


def stage_images(images: np.ndarray, mesh: Mesh | None = None):
    """The images of this process's shards, reflect-padded to block
    multiples, each group as a (per, H8, W8) uint8 tensor on its shard's
    device -- one tensor, or a tuple of them, one a shard of this process
    in a local mesh, in local order -- and the batch's size: the
    ``staged`` argument of :func:`compress_batch` (which then skips the
    host-to-device transfer)."""
    if mesh is None:
        mesh = make_mesh()
    images = np.asarray(images)
    if images.ndim != 3 or images.shape[0] < 1:
        raise ValueError("expected a non-empty (B, H, W) batch")
    b = images.shape[0]
    with profiling.span("codec.encode.upload"):
        staged = tuple(
            torch.from_numpy(np.ascontiguousarray(
                transform.pad_to_blocks(images[_group(b, mesh.size, r)]),
                dtype=np.uint8)).to(dev)
            for r, dev in mesh.shards())
    return (staged if len(staged) > 1 else staged[0]), b


def _encode_groups(mesh, images, quality, precision, bits_per_pixel_budget,
                   staged, block_index, index_stride) -> list[bytes]:
    if staged is None:
        staged = stage_images(images, mesh)
    local, b = staged
    if isinstance(local, tuple):  # one tensor a shard of a local mesh
        local = local[mesh.local_rank]
    true_shape = (tuple(np.shape(images)[1:3]) if images is not None
                  else tuple(local.shape[1:]))
    refused = None
    try:
        own = compress_batch_device(
            local, quality, bits_per_pixel_budget, precision=precision,
            block_index=block_index, index_stride=index_stride,
            true_shape=true_shape, device=mesh.device,
        )
    except TableRangeError as e:
        refused = e
    # a refusal of one shard's images is raised on every shard, before any
    # of them waits in the gather for a shard that will not come
    if mesh.any(refused is not None):
        raise refused or TableRangeError(
            "coefficient out of Huffman table range on another rank")
    return mesh.all_gather_bytes(own)[:b]


def compress_batch(
    images: np.ndarray | None,
    quality: int = 50,
    mesh: Mesh | None = None,
    precision: str = transform.EXACT,
    assemble: str = "host",
    bits_per_pixel_budget: float = 4.0,
    staged=None,
    block_index: bool = False,
    index_stride: int = container.INDEX_STRIDE,
    device: str | torch.device | None = None,
) -> list[bytes]:
    """(B, H, W) same-shaped grayscale images -> one stream an image, in
    order (on every rank of a process group).

    ``assemble``: ``"host"`` or ``"device"``, the JAX package's two modes.
    In the port both run the same kernels, which assemble every stream on
    the card, and both give the oracle's bytes in exact mode;
    ``block_index`` needs ``"host"``, as in the JAX package.  ``staged``:
    what :func:`stage_images` returned for the same mesh (``images`` may
    then be ``None``, and the header takes the padded size).  ``mesh=None``:
    :func:`make_mesh` -- every visible card, as the JAX function's mesh
    over ``jax.devices()``, or a world of one on ``device`` when that is
    given."""
    if assemble not in ("host", "device"):
        raise ValueError(f"unknown assemble mode {assemble!r}")
    if block_index and assemble != "host":
        raise ValueError("block_index requires assemble='host'")
    with profiling.span("codec.mesh.compress_batch"):
        if mesh is None:
            mesh = make_mesh(device=device)
        return mesh.run(_encode_groups, images, quality, precision,
                        bits_per_pixel_budget, staged, block_index,
                        index_stride)


def compress_batch_sharded(
    images: np.ndarray | None,
    quality: int = 50,
    mesh: Mesh | None = None,
    precision: str = transform.FAST,
    bits_per_pixel_budget: float = 4.0,
    staged=None,
    device: str | torch.device | None = None,
) -> list[bytes]:
    """The counterpart of the JAX package's
    ``compress_batch_pallas_sharded``: every shard runs ``exact_transform``
    (exact) / ``encode2`` / ``place`` on its group, ``exact_transform``
    settling its own flagged blocks -- the bytes of the JAX stage 1 ->
    host -> stage 2, the oracle's in exact mode.  No trailer.  ``mesh`` and ``device`` as in
    :func:`compress_batch`."""
    if mesh is None:
        mesh = make_mesh(device=device)
    return mesh.run(_encode_groups, images, quality, precision,
                    bits_per_pixel_budget, staged, False,
                    container.INDEX_STRIDE)


def decompress_batch_sharded(
    streams: list[bytes],
    mesh: Mesh | None = None,
    precision: str = transform.EXACT,
    device: str | torch.device | None = None,
) -> np.ndarray | None:
    """Same-shaped TICX standard-table streams -> (B, H, W) uint8, every
    shard decoding its group through ``Engine.decompress_batch`` (the
    ``entropy_decode`` kernel; an image with a corrupt chunk degrades to
    the host decoder, as there), the pixels gathered in order.

    ``None`` where the JAX function returns it: an empty list, a stream
    without a valid trailer, custom tables, groups of different shapes.
    Every shard reaches the same answer (the groups' keys are
    all-gathered); the caller routes such streams elsewhere.  ``mesh`` and
    ``device`` as in :func:`compress_batch`."""
    if not streams:
        return None
    if mesh is None:
        mesh = make_mesh(device=device)
    return mesh.run(_decode_groups, streams, precision)


def _decode_groups(mesh: Mesh, streams: list[bytes], precision: str):
    b = len(streams)
    group = [streams[i] for i in _group(b, mesh.size, mesh.rank)]
    prep = prepare_batch(group)
    if prep is None:
        key = [-1] * 6
    else:
        key = [*prep["shape"], prep["stride"], int(prep["scaled_dct"]),
               int(prep["tables"] is not None)]
    keys = [k.tolist() for k in mesh.all_gather(
        torch.tensor(key, dtype=torch.int64))]
    if any(k[0] < 0 or k[5] or k != keys[0] for k in keys):
        return None
    imgs = Engine(precision, mesh.device).decompress_batch(group)
    out = mesh.all_gather(torch.from_numpy(np.ascontiguousarray(imgs)))
    if not mesh.result_wanted:
        return None
    return torch.cat([t.cpu() for t in out]).numpy()[:b]
