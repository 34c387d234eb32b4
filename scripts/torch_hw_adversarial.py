#!/usr/bin/env python3
"""Adversarial conformance battery of the PyTorch/CUDA port on the card
-> reports/torch_hw_adversarial.json.

The counterpart of ``scripts/hw_adversarial.py``.  The CPU tests hold the
kernels' plain versions to the oracle; this script drives the compiled
CUDA kernels on the content where their designs differ most from those
plain versions (``tinyimgcodec_tpu_torch/conformance.py``,
:func:`adversarial`): noise, checkerboards, a gradient, flat and
saturated images and stripes at q 1-95, the q=99 refusal, capacity
budgets at a word's edge and at ``stitch``'s tail turns, small images,
the device decode of that content and auto-table streams.  It runs the
battery at 128x128 (the JAX script's size) and 512x512 (the corpus size).

Usage:
    python3 scripts/torch_hw_adversarial.py [--sizes 128,512]
        [--device cpu] [--out PATH]

Without ``--device`` it needs the card and raises without one;
``--device cpu`` runs the plain versions.  The last line of its output is
``{"all_passed": ..., "checks": n}``; the exit code is 0 only if every
check passed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tinyimgcodec_tpu_torch import conformance  # noqa: E402
from tinyimgcodec_tpu_torch.device import (  # noqa: E402
    card_info, resolve_device,
)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", default="128,512",
                   help="image sides of the batteries, comma-separated")
    p.add_argument("--device", default=None,
                   help="cpu for the plain versions (default: the card)")
    p.add_argument("--out", default=str(REPO / "reports"
                                        / "torch_hw_adversarial.json"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rec = {
        "card": card_info() if dev.type == "cuda" else "cpu (plain versions)",
        "device": str(dev),
        "batteries": [],
        "all_passed": True,
    }
    for size in (int(s) for s in args.sizes.split(",")):
        battery = conformance.adversarial(
            dev, size, log=lambda m: print(m, file=sys.stderr, flush=True))
        rec["batteries"].append(battery)
        rec["all_passed"] = rec["all_passed"] and battery["all_passed"]
    checks = sum(len(b["checks"]) for b in rec["batteries"])
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(json.dumps({"all_passed": rec["all_passed"], "checks": checks}))
    return 0 if rec["all_passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
