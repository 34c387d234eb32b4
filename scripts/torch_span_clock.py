#!/usr/bin/env python3
"""The port's spans against the profiler's own timeline, and their cost.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 scripts/torch_span_clock.py [--out reports/span_clock.json]

At the corpus shape (49 images of 512x512, quality 50, exact, TICX index)
it makes ``CALLS`` calls each of ``api.compress_batch`` and
``api.decompress_batch`` under ``torch.profiler`` (the host and the card)
and matches every ``codec.*`` record of ``profiling.spans()`` to the
profiler's event of the same name (the n-th record of a name to the n-th
event).  It prints the offsets of the records' starts and ends from the
events' (record minus event, microseconds: median and largest magnitude),
the records of each name a call with their counts, and what a span costs
with no profiler on (microseconds a span over ``OFF_SPANS`` spans, with and
without a ``set`` of a count).

``--device cpu`` runs the same at 3 images of 64x64, without a card.
Output: one JSON object; exits 2 without a CUDA device unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from tinyimgcodec_tpu_torch import api, profiling  # noqa: E402
from tinyimgcodec_tpu_torch.corpus import synthetic_corpus  # noqa: E402

CALLS = 20
OFF_SPANS = 10**6


def _off_cost() -> dict:
    span = profiling.span
    t = time.perf_counter()
    for _ in range(OFF_SPANS):
        with span("codec.encode.upload"):
            pass
    plain = (time.perf_counter() - t) / OFF_SPANS * 1e6
    t = time.perf_counter()
    for _ in range(OFF_SPANS):
        with span("codec.encode.recompute") as s:
            s.set(flagged=1)
    with_set = (time.perf_counter() - t) / OFF_SPANS * 1e6
    t = time.perf_counter()
    for _ in range(OFF_SPANS):
        pass
    loop = (time.perf_counter() - t) / OFF_SPANS * 1e6
    return {"off_span_us": plain, "off_span_set_us": with_set,
            "empty_loop_us": loop}


def _offsets(records, events) -> dict:
    """The n-th record of each name against the n-th event of it."""
    by_name = defaultdict(list)
    for e in events:
        by_name[e.name()].append(e)
    rec_by_name = defaultdict(list)
    for r in records:
        rec_by_name[r.name].append(r)
    starts, ends, unmatched = [], [], {}
    for name, recs in rec_by_name.items():
        evs = sorted(by_name.get(name, []), key=lambda e: e.start_ns())
        recs = sorted(recs, key=lambda r: r.start_ns)
        if len(evs) != len(recs):
            unmatched[name] = [len(recs), len(evs)]
        for r, e in zip(recs, evs):
            starts.append((r.start_ns - e.start_ns()) / 1e3)
            ends.append((r.end_ns - e.start_ns() - e.duration_ns()) / 1e3)

    def stats(xs):
        return {"median": float(np.median(xs)),
                "max_abs": float(np.max(np.abs(xs)))} if xs else None

    return {"start_us": stats(starts), "end_us": stats(ends),
            "matched": len(starts), "unmatched": unmatched}


def main() -> int:
    p = argparse.ArgumentParser(prog="scripts/torch_span_clock.py")
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    on_card = args.device is None
    if on_card and not torch.cuda.is_available():
        print("torch_span_clock: no CUDA device available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    n, size = (49, 512) if on_card else (3, 64)
    images = synthetic_corpus(n, size)
    streams = api.compress_batch(images, device=args.device)
    api.decompress_batch(streams, device=args.device)  # warm
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    t0 = time.time_ns()
    with profile(activities=acts) as prof:
        for _ in range(CALLS):
            api.compress_batch(images, device=args.device)
            api.decompress_batch(streams, device=args.device)
        if on_card:
            torch.cuda.synchronize()
    records, dropped = profiling.spans()
    records = [r for r in records if r.start_ns >= t0]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("codec.")
              and str(e.device_type()).endswith("CPU")]
    per_call = defaultdict(int)
    counts = defaultdict(lambda: defaultdict(int))
    for r in records:
        per_call[r.name] += 1
        for k, v in r.counts.items():
            counts[r.name][k] += v
    out = {
        "device": (torch.cuda.get_device_name(0) if on_card else "cpu"),
        "torch": torch.__version__,
        "calls": CALLS, "records": len(records), "dropped": dropped,
        "offsets": _offsets(records, events),
        "spans_a_call": {k: v / CALLS for k, v in sorted(per_call.items())},
        "counts_a_call": {k: {c: v / CALLS for c, v in d.items()}
                          for k, d in sorted(counts.items())},
        **_off_cost(),
    }
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
