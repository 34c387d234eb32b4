"""Tracing, profiling and run records.

The counterpart of the JAX package's ``profiling.py``:

- :class:`StageTimer` -- named wall-clock spans with JSON export;
- :func:`trace` -- ``torch.profiler`` around a block of code, written as a
  Chrome trace (``chrome://tracing``, Perfetto);
- :func:`device_sync_cost` -- the host time of one ``synchronize`` of the
  card;
- :func:`run_record` -- one JSON-able record of a run, naming the device
  it ran on.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch

from .device import resolve_device


class StageTimer:
    """Accumulating named wall-clock spans."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": round(v, 6), "count": self.counts[k]}
            for k, v in sorted(self.totals.items())
        }

    def json(self) -> str:
        return json.dumps(self.summary())


@contextlib.contextmanager
def trace(log_dir: str, device: str | torch.device | None = None):
    """Profile the block with ``torch.profiler`` (the card's kernels too,
    unless ``device="cpu"``) and write ``<log_dir>/trace.json`` as a
    Chrome trace.  Yields the profiler (``key_averages()`` for sums)."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_sync_cost(reps: int = 5,
                     device: str | torch.device | None = None) -> float:
    """Median seconds of one small launch and ``torch.cuda.synchronize``
    (on the CPU, of a small operation alone)."""
    dev = resolve_device(device)
    x = torch.zeros(1, device=dev)
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        x.add_(1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    times = sorted(times[1:])  # the first call warms up
    return times[len(times) // 2]


def run_record(
    workload: str,
    megapixels: float,
    seconds: float,
    extra: dict | None = None,
    device: str | torch.device | None = None,
    mesh=None,
) -> dict:
    """Canonical record of a run (one JSON-able dict): its rate and the
    device it ran on -- the card's name and the number of cards, or
    ``"cpu"`` when the caller asked for it.  With a ``parallel`` mesh the
    device is its first shard's and ``n_devices`` its number of shards,
    as the JAX record's ``len(jax.devices())`` is its mesh's default."""
    dev = resolve_device(mesh.device if mesh is not None else device)
    on_card = dev.type == "cuda"
    rec = {
        "workload": workload,
        "megapixels": round(megapixels, 4),
        "seconds": round(seconds, 6),
        "mp_per_s": round(megapixels / seconds, 2) if seconds else None,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "n_devices": (mesh.size if mesh is not None
                      else torch.cuda.device_count() if on_card else 1),
        "timestamp": time.time(),
    }
    if extra:
        rec.update(extra)
    return rec
