"""The traced run: a ``torch.profiler`` window and its reduction.

The window's events are reduced to a plain timeline that the per-layer
readers share (and that the tests build by hand):

- ``window``: (start, end) in ns, from the first of the benchmark's own
  spans around a call to the end of the last;
- ``device_ops``: (card, start, end, name, kind) of every kernel
  (``kernel``), memset (``memset``), copy between host and card
  (``host_copy``) and copy on or between cards (``card_copy``);
- ``spans``: (start, end, name) of the benchmark's spans around each call;
- ``host_ops``: (start, end, name) of the operations and CUDA runtime calls
  of the thread that opened the spans, sorted by start;
- ``cards``: the cards the cell uses.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

NAME_CHARS = 100  # of a kernel's name in the breakdown
BREAKDOWN_ROWS = 10
SCAN_BACK = 5000  # host operations looked at for one gap


class Window:
    """A profiler over the card(s) and the host (the host alone with
    ``cuda=False``), started and stopped around the measured loop; each
    call is wrapped in a span of the entry's name (``span``)."""

    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def span(self, name: str):
        from torch.profiler import record_function

        return record_function(name)

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> list:
        self.prof.stop()
        return list(self.prof.profiler.kineto_results.events())


def _copy_kind(name: str) -> str:
    return "host_copy" if ("HtoD" in name or "DtoH" in name) else "card_copy"


def _kind(e, span_names: set[str]) -> str:
    """``span``, a device kind, ``host`` or ``other`` for one event, told by
    its device and name: CUDA's copies and memsets are named ``Memcpy ...``
    and ``Memset ...``, and a span's device-side copy bears the span's
    name."""
    name = e.name()
    if e.is_user_annotation() or name in span_names:
        return ("span" if name in span_names
                and str(e.device_type()).endswith("CPU") else "other")
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith("Memcpy"):
            return _copy_kind(name)
        return "memset" if name.startswith("Memset") else "kernel"
    return "host"


def timeline(events, span_names: set[str], cards: list[int]) -> dict | None:
    """Kineto events -> the timeline above; ``None`` when the window holds
    none of the benchmark's spans."""
    spans, device_ops, host = [], [], []
    for e in events:
        kind = _kind(e, span_names)
        if kind == "other":
            continue
        start = e.start_ns()
        end = start + e.duration_ns()
        if kind == "span":
            spans.append((start, end, e.name(), e.start_thread_id()))
        elif kind == "host":
            host.append((start, end, e.name(), e.start_thread_id()))
        else:
            device_ops.append((e.device_index(), start, end, e.name(), kind))
    if not spans:
        return None
    spans.sort()
    thread = spans[0][3]
    host_ops = sorted((s, t, n) for s, t, n, th in host if th == thread)
    return {"window": (spans[0][0], max(s[1] for s in spans)),
            "device_ops": device_ops,
            "spans": [(s, t, n) for s, t, n, _ in spans],
            "host_ops": host_ops, "cards": list(cards)}


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_and_gaps(tl: dict):
    """Per card: the ns in which an operation ran on it inside the window,
    and the idle gaps (start, end) between them."""
    a, b = tl["window"]
    per_card = defaultdict(list)
    for card, s, e, _, _ in tl["device_ops"]:
        s, e = max(s, a), min(e, b)
        if e > s:
            per_card[card].append((s, e))
    busy, gaps = {}, {}
    for card in tl["cards"]:
        merged = _merged(per_card.get(card, []))
        busy[card] = sum(e - s for s, e in merged)
        edges = [a] + [x for iv in merged for x in iv] + [b]
        gaps[card] = [(edges[i], edges[i + 1])
                      for i in range(0, len(edges), 2)
                      if edges[i + 1] > edges[i]]
    return busy, gaps


def _label(tl: dict, t: int, span_starts: list[int],
           starts: list[int]) -> str:
    k = bisect.bisect_right(span_starts, t) - 1
    if k < 0 or tl["spans"][k][1] < t:
        return "harness"
    span = tl["spans"][k][2]
    ops = tl["host_ops"]
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - SCAN_BACK), -1):
        if ops[j][1] >= t:
            return f"{span} > {ops[j][2]}"
    return f"{span} > python"


def breakdown(tl: dict) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing (the benchmark's span and the innermost host
    operation open in the middle of each gap), seconds summed over the
    window and the cards."""
    ops = defaultdict(int)
    for _, s, e, name, _ in tl["device_ops"]:
        ops[name[:NAME_CHARS]] += e - s
    _, gaps = busy_and_gaps(tl)
    span_starts = [s for s, _, _ in tl["spans"]]
    starts = [s for s, _, _ in tl["host_ops"]]
    idle = defaultdict(int)
    for card_gaps in gaps.values():
        for s, e in card_gaps:
            idle[_label(tl, (s + e) // 2, span_starts, starts)] += e - s

    def top(d):
        rows = sorted(d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ROWS]
        return [[k, v / 1e9] for k, v in rows]

    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def summary(tl: dict | None) -> str:
    """What the window caught: device operations by kind and card, spans
    and host operations."""
    if tl is None:
        return "none of the benchmark's spans"
    kinds = defaultdict(int)
    for card, _, _, _, kind in tl["device_ops"]:
        kinds[f"{kind}@{card}"] += 1
    return (f"{len(tl['spans'])} spans, {len(tl['host_ops'])} host ops, "
            f"device ops {dict(sorted(kinds.items()))}")
