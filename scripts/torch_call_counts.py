#!/usr/bin/env python3
"""What one corpus encode call puts on the card, counted under the profiler.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 scripts/torch_call_counts.py [--seed N] [--calls 20]

Makes the two inputs of the benchmark's ``corpus512.encode`` cell from the
seed (``portbench.traffic``: 49 images of 512x512 each, quality 50, exact,
TICX index), warms them, and profiles ``--calls`` calls of
``api.compress_batch``, each inside a span named as the benchmark names
it.  It prints, a call: the card's kernels, host copies and memsets (told
apart as ``portbench.tracing`` tells them), the host operations
``aten::nonzero`` and ``aten::index_put_`` (each a sign of a host step in
the exact path), the mean device microseconds of ``exact_transform_kernel``;
and the ``flagged`` counts the program's spans recorded, beside the plain
version's count of tie-flagged blocks of each input on the CPU.  It reads
only public functions and the span records, so it runs on an older tree
too (copy it into that checkout), for two trees in one call.

``--device cpu`` runs the same on the plain versions (no device counts).
Output: one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.getcwd())

from portbench import tracing  # noqa: E402
from portbench.traffic import pool_inputs  # noqa: E402
from tinyimgcodec_tpu_torch import api, profiling  # noqa: E402
from tinyimgcodec_tpu_torch.ops import exact_transform, transform  # noqa: E402
from tinyimgcodec_tpu_torch.tables import CodecTables  # noqa: E402

CONFIG = "portbench/configs/corpus512-q50-exact.json"
ENTRY = "api.compress_batch"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=3190000501)
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("torch_call_counts: no CUDA device available", file=sys.stderr)
        return 2
    with open(CONFIG) as f:
        cfg = json.load(f)
    pool = pool_inputs(cfg, args.seed, 2)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for x in pool:
        api.compress_batch(x, device=args.device)
    sync()
    before = {r.span_id for r in profiling.spans()[0]}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        for k in range(args.calls):
            with record_function(ENTRY):
                api.compress_batch(pool[k % 2], device=args.device)
        sync()
    events = list(prof.profiler.kineto_results.events())
    tl = tracing.timeline(events, {ENTRY}, [0])
    kinds = Counter(kind for *_, kind in tl["device_ops"])
    names = Counter(e.name() for e in events)
    kernel = [e.duration_ns() for e in events
              if "exact_transform_kernel" in e.name()]
    flagged = [r.counts["flagged"] for r in profiling.spans()[0]
               if r.span_id not in before and "flagged" in r.counts
               and r.name.startswith("codec.encode.")]
    tables = CodecTables.build(cfg["quality"], "cpu")
    plain = [int(exact_transform.exact_transform_plain(
        transform.blockify(torch.from_numpy(x)).reshape(-1, 64),
        tables)[1].sum()) for x in pool]
    print(json.dumps({
        "seed": args.seed, "calls": args.calls,
        "device_ops_per_call": {k: v / args.calls for k, v in kinds.items()},
        "nonzero_per_call": names.get("aten::nonzero", 0) / args.calls,
        "index_put_per_call": names.get("aten::index_put_", 0) / args.calls,
        "exact_transform_kernel_us": (sum(kernel) / len(kernel) / 1e3
                                      if kernel else None),
        "flagged_on_spans": flagged[:2], "plain_counts": plain,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
