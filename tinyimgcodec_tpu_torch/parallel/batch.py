"""Data-parallel batches: images split over the ranks of a mesh.

The counterpart of the JAX package's ``parallel/batch.py``.  Each image is
a self-contained stream, so nothing is carried across ranks: the batch is
split into one group of ``ceil(B / world)`` consecutive images a rank (the
last group padded with repeats of the last image, so every rank runs the
same shapes), each rank runs the port's pipeline on its group --
``exact_transform`` (exact), ``encode2`` and ``place``, with the float64
recompute of its own flagged blocks, or the decode kernel -- and the
results are all-gathered in the caller's order, the padding dropped.

Exact mode gives the float64 oracle's bytes whatever the world size.  Not
carried over from the JAX package: its XLA batch programs
(``_batch_body``, ``_stream_body``; the port's kernels replace them) and
the 128-lane "not tileable" refusal, a TPU rule.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import container
from ..engine import Engine
from ..ops import transform
from ..ops.entropy_decode import prepare_batch
from ..pipeline import TableRangeError, compress_batch_device
from .mesh import Mesh, make_mesh


def _group(b: int, mesh: Mesh) -> list[int]:
    """The batch indices of this rank: ``ceil(b / world)`` of them, those
    past the batch repeating its last image."""
    per = -(-b // mesh.size)
    return [min(i, b - 1) for i in range(mesh.rank * per,
                                         (mesh.rank + 1) * per)]


def stage_images(images: np.ndarray, mesh: Mesh | None = None):
    """This rank's images, reflect-padded to block multiples, as a
    (per, H8, W8) uint8 tensor on the mesh's device, and the batch's size:
    the ``staged`` argument of :func:`compress_batch` (which then skips the
    host-to-device transfer)."""
    if mesh is None:
        mesh = make_mesh()
    images = np.asarray(images)
    if images.ndim != 3 or images.shape[0] < 1:
        raise ValueError("expected a non-empty (B, H, W) batch")
    own = images[_group(images.shape[0], mesh)]
    padded = np.ascontiguousarray(transform.pad_to_blocks(own),
                                  dtype=np.uint8)
    return torch.from_numpy(padded).to(mesh.device), images.shape[0]


def _encode_groups(images, quality, mesh, precision, bits_per_pixel_budget,
                   staged, block_index, index_stride) -> list[bytes]:
    if staged is None:
        staged = stage_images(images, mesh)
    local, b = staged
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
    # a refusal of one rank's images is raised on every rank, before any
    # of them waits in the gather for a rank that will not come
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
    order, on every rank.

    ``assemble``: ``"host"`` or ``"device"``, the JAX package's two modes.
    In the port both run the same kernels, which assemble every stream on
    the card, and both give the oracle's bytes in exact mode;
    ``block_index`` needs ``"host"``, as in the JAX package.  ``staged``:
    ``(tensor, B)`` from :func:`stage_images` (``images`` may then be
    ``None``, and the header takes the padded size).  ``device``: the
    device of the default mesh (``None`` = the card)."""
    if assemble not in ("host", "device"):
        raise ValueError(f"unknown assemble mode {assemble!r}")
    if block_index and assemble != "host":
        raise ValueError("block_index requires assemble='host'")
    if mesh is None:
        mesh = make_mesh(device=device)
    return _encode_groups(images, quality, mesh, precision,
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
    ``compress_batch_pallas_sharded``: every rank runs ``exact_transform``
    (exact) / ``encode2`` / ``place`` on its group and recomputes its own
    flagged blocks -- the bytes of the JAX stage 1 -> host -> stage 2, the
    oracle's in exact mode.  No trailer."""
    if mesh is None:
        mesh = make_mesh(device=device)
    return _encode_groups(images, quality, mesh, precision,
                          bits_per_pixel_budget, staged, False,
                          container.INDEX_STRIDE)


def decompress_batch_sharded(
    streams: list[bytes],
    mesh: Mesh | None = None,
    precision: str = transform.EXACT,
    device: str | torch.device | None = None,
) -> np.ndarray | None:
    """Same-shaped TICX standard-table streams -> (B, H, W) uint8, every
    rank decoding its group through ``Engine.decompress_batch`` (the
    ``entropy_decode`` kernel; an image with a corrupt chunk degrades to
    the host decoder, as there), the pixels gathered in order.

    ``None`` where the JAX function returns it: an empty list, a stream
    without a valid trailer, custom tables, groups of different shapes.
    Every rank reaches the same answer (the groups' keys are
    all-gathered); the caller routes such streams elsewhere."""
    if not streams:
        return None
    if mesh is None:
        mesh = make_mesh(device=device)
    b = len(streams)
    group = [streams[i] for i in _group(b, mesh)]
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
    return torch.cat([t.cpu() for t in out]).numpy()[:b]
