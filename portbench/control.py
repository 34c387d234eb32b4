"""The comparison's two readings, many seeds in one process.

``--precision`` left out runs the cell as its configuration states: sound
runs, whose numbers set the lower reading of each limit.  ``--precision
fast`` runs the control: the program's own float32 path in place of the
exact one that the configurations state, which the comparison has to
refuse; its numbers set the upper reading.  Each seed is one run of the
harness (inputs, warm-up, a window of ``--seconds``, the comparison); the
process, the card and the kernels are set up once.

    python3 portbench/control.py --workload corpus512.encode \
        --seeds 1,2,3 --seconds 3 [--precision fast]

prints one JSON line a seed: the seed, ``correct`` and the numbers
compared.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    BASE = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BASE]
    sys.path.insert(0, str(BASE.parent))
    os.environ["TINYIMGCODEC_TORCH_BUILD_DIR"] = str(BASE.parent / "build")

from portbench.harness import run  # noqa: E402
from portbench.loader import Bench  # noqa: E402


def readings(bench: Bench, cell: str, seeds, seconds: float,
             precision: str | None = None, device: str | None = None):
    """(seed, correct, {number: value}) of one run a seed."""
    out = []
    for seed in seeds:
        r = run(bench, cell, seed, seconds, False, time.perf_counter(),
                device=device, log=lambda *a, **k: None,
                precision=precision)
        out.append((seed, r["correct"],
                    {k: v["value"] for k, v in r["checks"].items()}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated whole numbers")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--precision", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, correct, numbers in readings(Bench(), args.workload, seeds,
                                           args.seconds, args.precision):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision, "correct": correct,
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
