#!/usr/bin/env python3
"""Weak-scaling harness of the port's sharded encode -> reports/torch_scaling.json.

The counterpart of ``scripts/scaling_bench.py``: N ranks joined in one
``torch.distributed`` group by ``parallel.mesh.spawn``, each encoding
``--per-proc`` images of ``--size`` x ``--size`` at q=50 through
``parallel.batch.compress_batch_sharded`` (fast: ``encode2`` + ``place``
on its own group of images, the streams all-gathered in order), so every
timed step holds a real collective.  The per-rank work is fixed and the
total grows with N:

    efficiency(N) = MP/s(N) / (N * MP/s(1))

A step's time is the slowest rank's (host clock, synchronised), the
median over ``--reps`` after one warm step.  Every rank's streams are
checked against one process's ``compress_batch`` of the same images; a
difference makes the script exit 1.

With ``--device cuda`` rank r runs on card ``r % device_count``.  Ranks
that share one card (every rank on ``cuda:0`` on a one-card machine)
share its queue and its host, so their rows measure no scaling; nor do
CPU ranks past the machine's cores.  The
record carries ``cores`` and the card so that a reader can judge.  NCCL
puts no two ranks on one card, so an NCCL world larger than the cards is
recorded as skipped.

Usage:
    python3 scripts/torch_scaling_bench.py [--procs 1,2] [--per-proc 4]
        [--size 512] [--reps 5] [--backend gloo,nccl]
        [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tinyimgcodec_tpu_torch import api  # noqa: E402
from tinyimgcodec_tpu_torch.corpus import synthetic_corpus  # noqa: E402
from tinyimgcodec_tpu_torch.device import (  # noqa: E402
    card_info, card_lines, resolve_device,
)
from tinyimgcodec_tpu_torch.parallel import spawn  # noqa: E402
from tinyimgcodec_tpu_torch.parallel.batch import (  # noqa: E402
    compress_batch_sharded,
)

QUALITY = 50


def _sha(streams: list[bytes]) -> str:
    return hashlib.sha256(b"".join(streams)).hexdigest()


def _rank(mesh, per: int, size: int, reps: int) -> dict:
    """One rank: a warm step, then ``reps`` timed steps of the sharded
    encode of ``mesh.size * per`` images; its times and the sha256 of the
    streams it ended with (every rank holds all of them)."""
    if mesh.device.type == "cpu":
        torch.set_num_threads(1)  # one core a rank, as one rank a core
    images = synthetic_corpus(mesh.size * per, size)

    def step():
        out = compress_batch_sharded(images, QUALITY, mesh=mesh)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return out

    step()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = step()
        times.append(time.perf_counter() - t0)
    return {"rank": mesh.rank, "times": times, "sha256": _sha(out)}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--procs", default="1,2")
    p.add_argument("--per-proc", type=int, default=4)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--backend", default="gloo",
                   help="gloo, nccl or both, comma-separated")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=str(REPO / "reports"
                                        / "torch_scaling.json"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cores = os.cpu_count() or 1
    procs = [int(x) for x in args.procs.split(",")]
    runs, all_equal = {}, True
    for backend in args.backend.split(","):
        rows, base = [], None
        for n in procs:
            if (backend == "nccl" and dev.type == "cuda"
                    and n > torch.cuda.device_count()):
                rows.append({"procs": n, "skipped": (
                    "NCCL puts no two ranks on one card; the machine has "
                    f"{torch.cuda.device_count()}")})
                continue
            t0 = time.perf_counter()
            # "cuda" (no index): rank r on card r % device_count
            ranks = spawn(_rank, n, backend=backend, device=args.device,
                          args=(args.per_proc, args.size, args.reps))
            spawn_s = time.perf_counter() - t0
            images = synthetic_corpus(n * args.per_proc, args.size)
            want = _sha(api.compress_batch(images, QUALITY,
                                           precision="fast",
                                           block_index=False, device=dev))
            equal = all(r["sha256"] == want for r in ranks)
            all_equal = all_equal and equal
            # a step ends when its slowest rank does (the all-gather waits)
            step = [max(r["times"][i] for r in ranks)
                    for i in range(args.reps)]
            med = float(np.median(step))
            mps = n * args.per_proc * args.size ** 2 / 1e6 / med
            if base is None:
                base = mps / n
            row = {"procs": n, "mps": mps, "efficiency": mps / (n * base),
                   "step_s_median": med, "step_s": step,
                   "rank_s_median": [float(np.median(r["times"]))
                                     for r in ranks],
                   "spawn_and_join_s": spawn_s, "sha256_streams": want,
                   "streams_equal_one_process": equal}
            if dev.type == "cpu" and n > cores:
                row["oversubscribed"] = True
            rows.append(row)
            print(f"{backend} N={n}: {mps:.2f} MP/s, efficiency "
                  f"{row['efficiency']:.3f}, streams equal: {equal}",
                  file=sys.stderr, flush=True)
        runs[backend] = rows
    record = {
        "benchmark": "weak_scaling_sharded_encode",
        "card": card_info() if dev.type == "cuda" else None,
        "cards": card_lines() if dev.type == "cuda" else None,
        "device": str(dev),
        "cores": cores,
        "quality": QUALITY,
        "precision": "fast",
        "per_proc_images": args.per_proc,
        "image_size": args.size,
        "reps": args.reps,
        "backends": runs,
        "note": (
            "N ranks of parallel.mesh.spawn, each running "
            "compress_batch_sharded on its own images (encode2 + place), "
            "the streams all-gathered every step; host clock, a step is "
            "its slowest rank, median after one warm step; efficiency "
            "against the same backend's first row. Ranks that share one "
            "card (every rank on cuda:0 on a one-card machine) share its "
            "queue and its host: such rows measure no scaling, nor do CPU "
            "rows with more ranks than cores."),
    }
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps({
        "rows": {b: [(r["procs"], r.get("mps"), r.get("efficiency"))
                     for r in rows] for b, rows in runs.items()},
        "streams_equal": all_equal}))
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
