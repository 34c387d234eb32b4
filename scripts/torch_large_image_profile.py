#!/usr/bin/env python3
"""Host-side profile of one large image through the port on the card.

Encodes and decodes the 7680x4320 image of ``chip_smoke.py``'s ``tiled``
phase (``seeded_image(4320, 7680, 8)``, q=50, exact), times ``compress``
and ``Engine.decompress`` (host clock around synchronised calls, after two
warm ones), and prints the functions that took the most host time in one
call of each (``cProfile``, by own time).  Run from the root of a
checkout on a machine with the card:

    python3 scripts/torch_large_image_profile.py [--reps N]

Each line of output is one JSON object; the card's name and power limit
come first.  To compare two trees on one card, copy this script into
each and run them in turns in one call.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile_top(fn, n: int) -> list:
    pr = cProfile.Profile()
    pr.enable()
    fn()
    pr.disable()
    stats = pstats.Stats(pr).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    return [{"function": f"{os.path.basename(f)}:{line}({name})",
             "calls": v[1], "own_ms": v[2] * 1e3, "cumulative_ms": v[3] * 1e3}
            for (f, line, name), v in rows]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    sys.argv = [sys.argv[0]]  # chip_smoke reads its own flags
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import tinyimgcodec_tpu_torch as codec
    from tinyimgcodec_tpu_torch.device import card_info
    from tinyimgcodec_tpu_torch.engine import Engine
    from tinyimgcodec_tpu_torch.ops import _build

    print(json.dumps({"card": card_info(), "tree": ROOT}), flush=True)
    _build.build_all()
    img = chip_smoke.seeded_image(4320, 7680, 8)
    data = codec.compress(img, 50, device="cuda")
    engine = Engine("exact", "cuda")
    for label, fn in (("compress", lambda: codec.compress(img, 50,
                                                          device="cuda")),
                      ("decompress", lambda: engine.decompress(data))):
        times = []
        for i in range(args.reps + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)

        def once():
            fn()
            torch.cuda.synchronize()

        print(json.dumps({"call": label, "ms": times,
                          "median_ms": sorted(times)[len(times) // 2],
                          "top_own_time": profile_top(once, 8)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
