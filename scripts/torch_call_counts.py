#!/usr/bin/env python3
"""What one corpus encode (or decode) call puts on the card, counted under
the profiler.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 scripts/torch_call_counts.py [--seed N] [--calls 20] [--decode]

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

``--decode`` profiles ``api.decompress_batch`` of the two inputs' exact
streams instead (the benchmark's ``corpus512.decode`` call, from streams
this tree encodes, the reference's bytes): the same counts, the device
time a call of each kernel by name, and the ``flagged`` counts of the
decode spans beside ``exact_inverse``'s plain version's where the tree has
it.

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
    p.add_argument("--decode", action="store_true")
    args = p.parse_args(argv)
    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        print("torch_call_counts: no CUDA device available", file=sys.stderr)
        return 2
    with open(CONFIG) as f:
        cfg = json.load(f)
    pool = pool_inputs(cfg, args.seed, 2)
    entry, stage = ENTRY, "codec.encode."
    call = lambda x: api.compress_batch(x, device=args.device)  # noqa: E731
    if args.decode:
        pool = [api.compress_batch(x, device=args.device) for x in pool]
        entry, stage = "api.decompress_batch", "codec.decode."
        call = lambda x: api.decompress_batch(  # noqa: E731
            x, device=args.device)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for x in pool:
        call(x)
    sync()
    before = {r.span_id for r in profiling.spans()[0]}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        for k in range(args.calls):
            with record_function(entry):
                call(pool[k % 2])
        sync()
    events = list(prof.profiler.kineto_results.events())
    tl = tracing.timeline(events, {entry}, [0])
    kinds = Counter(kind for *_, kind in tl["device_ops"])
    names = Counter(e.name() for e in events)
    device_us = Counter()
    for _, s, e, name, _ in tl["device_ops"]:
        device_us[name[:80]] += (e - s) / 1e3 / args.calls
    kernel = [e.duration_ns() for e in events
              if "exact_transform_kernel" in e.name()]
    flagged = [r.counts["flagged"] for r in profiling.spans()[0]
               if r.span_id not in before and "flagged" in r.counts
               and r.name.startswith(stage)]
    if args.decode:
        plain = decode_plain_counts(pool, cfg)
    else:
        tables = CodecTables.build(cfg["quality"], "cpu")
        plain = [int(exact_transform.exact_transform_plain(
            transform.blockify(torch.from_numpy(x)).reshape(-1, 64),
            tables)[1].sum()) for x in pool]
    print(json.dumps({
        "seed": args.seed, "calls": args.calls, "entry": entry,
        "device_ops_per_call": {k: v / args.calls for k, v in kinds.items()},
        "nonzero_per_call": names.get("aten::nonzero", 0) / args.calls,
        "index_put_per_call": names.get("aten::index_put_", 0) / args.calls,
        "exact_transform_kernel_us": (sum(kernel) / len(kernel) / 1e3
                                      if kernel else None),
        "device_us_per_call_by_name": dict(device_us.most_common()),
        "flagged_on_spans": flagged[:2], "plain_counts": plain,
    }))
    return 0


def decode_plain_counts(pool, cfg) -> list | None:
    """The blocks ``exact_inverse``'s plain version flags in each input's
    streams, on the CPU; ``None`` on a tree without it."""
    try:
        from tinyimgcodec_tpu_torch.ops.exact_inverse import (
            exact_inverse_plain,
        )
    except ImportError:
        return None
    import numpy as np

    from tinyimgcodec_tpu_torch import container
    from tinyimgcodec_tpu_torch.tables import DecodeTables

    tables = DecodeTables.build(cfg["quality"], False, "cpu")
    out = []
    for streams in pool:
        rows = np.stack([
            np.concatenate([a.dc[:, None], a.ac], axis=1)
            for a in map(container.decompress_to_arrays, streams)])
        out.append(int(exact_inverse_plain(
            torch.from_numpy(rows.astype(np.int32)), cfg["height"],
            cfg["width"], tables)[1]))
    return out


if __name__ == "__main__":
    sys.exit(main())
