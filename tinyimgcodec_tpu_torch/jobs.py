"""Checkpointable corpus jobs: encode a set of images to files, resuming
after a crash.

The counterpart of the JAX package's ``jobs.py``.  Encode is stateless per
image, so a job checkpoints image by image: a manifest (written
atomically) records which inputs are done, and running the job again
skips them.  Each stream lands in its own file as soon as its batch is
encoded.  Same-shaped images go through ``compress_batch`` in batches of
``batch_size``; the manifest is still written after every image.  On a
mesh of several devices (by default every visible card) a batch is split
over them by ``parallel.batch.compress_batch``, as the JAX job does.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from . import api
from .parallel import Mesh, make_mesh
from .parallel.batch import compress_batch as sharded_compress_batch


class CorpusEncodeJob:
    """Encode a set of images to ``<name>.img`` files with resume support.

    ``mesh``: the devices a batch is split over (``None``:
    :func:`parallel.make_mesh` on ``device`` -- every visible card when
    ``device`` is ``None``, else that device alone); a mesh of one runs
    ``api.compress_batch`` on its device, a larger one
    ``parallel.batch.compress_batch`` with the block index, the same
    bytes.  ``backend="host"`` writes the float64 oracle's streams and
    needs no device."""

    def __init__(
        self,
        out_dir: str,
        quality: int = 50,
        backend: str = "auto",
        batch_size: int = 16,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
    ) -> None:
        self.out_dir = out_dir
        self.quality = quality
        self.backend = backend
        self.batch_size = batch_size
        self.device = device
        self._mesh = mesh
        self.manifest_path = os.path.join(out_dir, "manifest.json")
        os.makedirs(out_dir, exist_ok=True)
        self._manifest = self._load_manifest()

    def _load_manifest(self) -> dict:
        if os.path.exists(self.manifest_path):
            try:
                with open(self.manifest_path) as f:
                    return json.load(f)
            except (OSError, json.JSONDecodeError):
                pass  # a torn manifest: start over
        return {"quality": self.quality, "done": {}}

    def _save_manifest(self) -> None:
        # atomic write so a crash never corrupts resume state
        fd, tmp = tempfile.mkstemp(dir=self.out_dir, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(self._manifest, f)
        os.replace(tmp, self.manifest_path)

    def _encode_batch(self, batch: np.ndarray) -> list[bytes]:
        """A same-shaped batch -> its streams with the block index: the
        oracle's on the host, else over the mesh (made at first use)."""
        if self.backend == "host":
            return api.compress_batch(batch, quality=self.quality,
                                      backend="host")
        if self._mesh is None:
            self._mesh = make_mesh(device=self.device)
        if self._mesh.size == 1:
            return api.compress_batch(batch, quality=self.quality,
                                      backend=self.backend,
                                      device=self._mesh.device)
        # block_index=True: the public API's default trailer, so that a
        # mesh's files equal one device's
        return sharded_compress_batch(batch, quality=self.quality,
                                      mesh=self._mesh, block_index=True)

    def pending(self, names: list[str]) -> list[str]:
        done = self._manifest["done"]
        return [n for n in names if n not in done]

    def run(self, images: dict[str, np.ndarray],
            progress=None) -> dict[str, str]:
        """Encode all images not done yet; returns name -> output path."""
        names = self.pending(sorted(images))
        out_paths = {
            n: os.path.join(self.out_dir, f"{n}.img") for n in sorted(images)
        }
        # batches of one shape, at most batch_size images each
        chunks: list[list[str]] = []
        for name in names:
            if (not chunks
                    or images[name].shape != images[chunks[-1][-1]].shape
                    or len(chunks[-1]) >= self.batch_size):
                chunks.append([])
            chunks[-1].append(name)

        done_count = 0
        for chunk in chunks:
            streams = self._encode_batch(np.stack([images[n]
                                                   for n in chunk]))
            for name, data in zip(chunk, streams):
                tmp = out_paths[name] + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, out_paths[name])
                self._manifest["done"][name] = {
                    "bytes": len(data), "shape": list(images[name].shape)
                }
                self._save_manifest()
                done_count += 1
                if progress:
                    progress(done_count, len(names), name)
        return out_paths
