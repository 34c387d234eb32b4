"""Checkpointable corpus jobs: encode a set of images to files, resuming
after a crash.

The counterpart of the JAX package's ``jobs.py``.  Encode is stateless per
image, so a job checkpoints image by image: a manifest (written
atomically) records which inputs are done, and running the job again
skips them.  Each stream lands in its own file as soon as its batch is
encoded.  Same-shaped images go through ``compress_batch`` in batches of
``batch_size``; the manifest is still written after every image.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from . import api


class CorpusEncodeJob:
    """Encode a set of images to ``<name>.img`` files with resume support.

    ``device``: where the codec runs (``None`` = the card, as every entry
    point of the port); ``backend="host"`` writes the float64 oracle's
    streams and needs no device."""

    def __init__(
        self,
        out_dir: str,
        quality: int = 50,
        backend: str = "auto",
        batch_size: int = 16,
        device: str | torch.device | None = None,
    ) -> None:
        self.out_dir = out_dir
        self.quality = quality
        self.backend = backend
        self.batch_size = batch_size
        self.device = device
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
            streams = api.compress_batch(
                np.stack([images[n] for n in chunk]), quality=self.quality,
                backend=self.backend, device=self.device,
            )
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
