"""Scale-out over devices: one image cut into block ranges, batches of
images split over shards, and a double-buffered image stream.

The counterpart of the JAX package's ``parallel`` package:

- :mod:`.mesh` -- a 1-D mesh over every card of this process (one thread
  a card, the default of ``make_mesh()`` outside a process group, as
  JAX's mesh over ``jax.devices()``), over the ranks of a
  ``torch.distributed`` process group (NCCL on the card, gloo on the
  CPU), or over several cards in each process of a group
  (``make_mesh(devices=[...])`` inside it, JAX's multi-host mesh);
  ``init_distributed`` and ``spawn``.
- :mod:`.tiled` -- one image's blocks split into contiguous ranges over
  the shards, each encoded through the pipeline's block ranges (calls of
  at most ``pipeline.MAX_PIXELS`` pixels), with the DC predictor carried
  across every shard and the segments stitched at bit offsets.
- :mod:`.batch` -- data-parallel encode and decode of image batches.
- :mod:`.stream` -- double-buffered host-to-card encode of an image
  stream, and the chunked decode of a stream of streams.
"""

from .mesh import (  # noqa: F401
    LocalMesh, Mesh, RankFailure, init_distributed, make_mesh, rank_card,
    rank_devices, spawn,
)
