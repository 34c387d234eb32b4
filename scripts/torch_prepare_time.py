#!/usr/bin/env python3
"""Host time of the decode's ``prepare_batch`` at the corpus shape.

Run from the root of a checkout:

    python3 scripts/torch_prepare_time.py [--calls 2000] [--images 49]
                                          [--size 512]

Encodes ``--images`` images of the port's synthetic corpus (``--size``
square, quality 50, TICX index at stride 64) with the port's CPU encoder,
then times ``ops.entropy_decode.prepare_batch`` of those streams
``--calls`` times on the host clock, after a warm-up, and prints one JSON
object: the median, quartiles and least of the calls in milliseconds,
beside the streams' bytes and chunk count.  ``prepare_batch`` runs on the
host alone, so no card is needed.  The script reads only public functions,
so it runs on an older tree too (copy it into that checkout): time two
trees in turn on one machine to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())

import tinyimgcodec_tpu_torch as tic  # noqa: E402
from tinyimgcodec_tpu_torch.corpus import synthetic_corpus  # noqa: E402
from tinyimgcodec_tpu_torch.ops.entropy_decode import (  # noqa: E402
    prepare_batch,
)

QUALITY = 50
STRIDE = 64
WARM_CALLS = 20


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--calls", type=int, default=2000)
    p.add_argument("--images", type=int, default=49)
    p.add_argument("--size", type=int, default=512)
    args = p.parse_args(argv)
    streams = tic.compress_batch(
        synthetic_corpus(args.images, args.size), QUALITY, device="cpu",
        block_index=True, index_stride=STRIDE)
    prep = prepare_batch(streams)
    if prep is None:
        print("torch_prepare_time: prepare_batch refused the corpus streams",
              file=sys.stderr)
        return 1
    for _ in range(WARM_CALLS):
        prepare_batch(streams)
    ms = []
    for _ in range(args.calls):
        t0 = time.perf_counter()
        prepare_batch(streams)
        ms.append((time.perf_counter() - t0) * 1e3)
    q1, median, q3 = statistics.quantiles(ms, n=4)
    print(json.dumps({
        "script": "torch_prepare_time",
        "checkout": os.getcwd(),
        "streams": len(streams),
        "shape": [args.size, args.size],
        "quality": QUALITY,
        "stride": STRIDE,
        "stream_bytes": sum(map(len, streams)),
        "chunks": int(len(prep["chunk_start"])),
        "calls": args.calls,
        "median_ms": median,
        "q1_ms": q1,
        "q3_ms": q3,
        "min_ms": min(ms),
        "host": {"machine": platform.machine(), "cpus": os.cpu_count(),
                 "python": platform.python_version(),
                 "numpy": np.__version__},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
