"""Tracing, profiling and run records.

The counterpart of the JAX package's ``profiling.py``:

- :func:`span` -- one stage of the codec (``codec.*``), recorded while a
  torch profiler is on in the calling thread (or in the caller of a
  ``LocalMesh`` run, for its shard threads): as an event in the profiler's
  own timeline, beside the torch operations and kernels it launches, and
  as a :class:`SpanRecord` in a bounded buffer; with no profiler on it
  records nothing;
- :func:`spans` -- a copy of that buffer and the count of records it
  dropped;
- :func:`trace` -- ``torch.profiler`` around a block of code, written as a
  Chrome trace (``chrome://tracing``, Perfetto) that shows the spans;
- :func:`device_sync_cost` -- the host time of one ``synchronize`` of the
  card;
- :func:`run_record` -- one JSON-able record of a run, naming the device
  it ran on.

The spans and their counts (``README.md``, "Tracing the port"):

- calls: ``codec.compress``, ``codec.compress_batch``,
  ``codec.decompress`` and ``codec.decompress_batch`` (``api.py``; the two
  decode calls count the images each decode leg took: ``kernel``,
  ``host_entropy``, ``host_decoder``), ``codec.mesh.compress_batch``
  (``parallel/batch.py``);
- encode stages (``pipeline.py``): ``codec.encode.upload``,
  ``.transform`` (``flagged``: the tie-flagged blocks ``exact_transform``
  settled on the device, read with the status of ``.place``), ``.entropy``
  (``from_pixels``: the blocks the entropy kernel transformed from pixels
  itself, fast mode), ``.place`` (``retried``: 1 when the stream was assembled again at the
  worst-case capacity), ``.pull``, ``.assemble``;
- decode stages (``engine.py``): ``codec.decode.prepare``, ``.upload``,
  ``.entropy``, ``.transform`` (``flagged``, exact mode: the tie-flagged
  blocks ``exact_inverse`` settled on the device, read after ``.pull``),
  ``.pull``, ``.fallback`` (``images``: those the host decoder took);
  on the host-entropy leg ``.host_entropy`` (``streams``, and ``threads``:
  the C decoder's pool), ``.compact`` (``outliers``: the AC values sent
  apart; ``wide``: 1 where the AC goes up as int16), then ``.upload``
  (the narrow copies and the widening).

The outermost span of a call takes a fresh call id, which every span
nested in it records, with its parent's span id; a ``LocalMesh`` runs each
shard in a copy of its caller's context, so the shards' spans carry the
caller's call id, and their shard's rank and device.  Times are
``time.time_ns()``, the clock of the profiler's host events.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

from .device import resolve_device

# records kept: 10 s of traced calls with room to spare (about 350 calls
# of a four-card mesh, 10 spans a call on each card, or 1800 one-card
# decode calls of 7 spans each)
SPAN_BUFFER = 1 << 16


class SpanRecord(NamedTuple):
    """One span: its name, start and end (``time.time_ns()``), the thread
    that ran it (``threading.get_ident()``), the device and rank of its
    ``LocalMesh`` shard (``None`` and 0 outside a mesh), its call's id, its
    own id, its parent's id (``None`` for a call's outermost span) and its
    counts."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    device: str | None
    shard: int
    call_id: int
    span_id: int
    parent_id: int | None
    counts: dict


_BUFFER: deque = deque(maxlen=SPAN_BUFFER)
_LOCK = threading.Lock()
_dropped = 0
_IDS = itertools.count(1)
# the innermost open span of this context: (call id, span id)
_OPEN: contextvars.ContextVar = contextvars.ContextVar(
    "tinyimgcodec_open_span", default=None)
# the mesh shard this context runs: (rank, device, whether its caller was
# profiled)
_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "tinyimgcodec_shard", default=(0, None, False))


class _Off:
    """What :func:`span` returns with no profiler on: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "counts", "_event", "_token", "_ids", "_start")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts

    def set(self, **counts) -> None:
        """Add or replace counts of this span (known once it has run; after
        it has closed too, since its record holds the same counts)."""
        self.counts.update(counts)

    def __enter__(self):
        own = next(_IDS)
        parent = _OPEN.get()
        self._ids = ((own, own, None) if parent is None
                     else (parent[0], own, parent[1]))
        self._token = _OPEN.set(self._ids[:2])
        self._event = _RecordFunctionFast(self.name)
        self._event.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        self._event.__exit__(*exc)
        _OPEN.reset(self._token)
        shard, device, _ = _SHARD.get()
        _keep(SpanRecord(self.name, self._start, end, threading.get_ident(),
                         device, shard, *self._ids, self.counts))
        return False


def _keep(record: SpanRecord) -> None:
    global _dropped
    with _LOCK:
        if len(_BUFFER) == _BUFFER.maxlen:
            _dropped += 1
        _BUFFER.append(record)


def active() -> bool:
    """Whether :func:`span` records here: a torch profiler is on in this
    thread, or this is a shard of a ``LocalMesh`` run whose caller had
    one on."""
    return _profiler_enabled() or _SHARD.get()[2]


def span(name: str, **counts):
    """A context manager around one stage named ``name``, with ``counts``
    (integers; ``.set(**counts)`` adds more inside the block).  It records
    only while :func:`active`; otherwise it is a shared object that does
    nothing."""
    if not (_profiler_enabled() or _SHARD.get()[2]):
        return _OFF
    return _Span(name, counts)


def enter_shard(rank: int, device, traced: bool) -> None:
    """Mark the current context (a copy of a mesh caller's, one a shard) as
    shard ``rank`` on ``device``; ``traced``: whether the caller was
    :func:`active`, so the shard's spans record in its own thread too."""
    _SHARD.set((rank, str(device), traced))


def spans() -> tuple[list[SpanRecord], int]:
    """The records kept (the newest :data:`SPAN_BUFFER`, in the order the
    spans ended) and the count of older ones dropped since the process
    began."""
    with _LOCK:
        return list(_BUFFER), _dropped


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
