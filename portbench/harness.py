"""One run of one cell, from its files to the result line.

1. load the cell, its configuration, mix, entry, what the mix sends and how
   its calls arrive (``loader.py``);
2. make the pool of inputs from ``--seed`` (``traffic.py``) and the items
   the window sends (``sends/<kind>.py``; the decode cells' streams come
   from the reference encoder, whose seconds ``setup_s`` leaves out);
3. build the entry's state and call it on every item of the pool twice,
   which builds and loads every kernel and warms every shape the window uses;
   ``setup_s`` ends here;
4. call the entry as the mix's loop says (``loops/<kind>.py``) for
   ``--seconds`` (under the profiler with ``--trace 1``); each answer drawn
   for the comparison is compared in place with the first answer of its
   input (``Answers``);
5. read the card's memory peak, free the program's state, compute the
   reference's answers and compare (``compare.py``), read the metrics;
6. check that no module of JAX or the JAX package was loaded, and print the
   result as one JSON line, the numbers compared last.

A call is timed on the host clock from the call (or from its arrival, where
the loop gives one) to its return with the answer in host memory.  The
window runs from the first call to the return of the last one started
before ``--seconds`` had passed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np

from . import compare, tracing, traffic
from .loader import Bench

FORBIDDEN = {"jax", "jaxlib", "flax", "tinyimgcodec_tpu"}
WARM_ROUNDS = 2


@dataclass
class Context:
    """What an entry's ``setup`` is given: the configuration, the chips the
    cell asks for, and the device (``None``: the card, as users call the
    codec; ``"cpu"``: the kernels' plain versions, for the tests)."""

    config: dict
    chips: int
    device: str | None = None


class Answers:
    """The answers kept for the comparison.  The first answer of each pool
    input is kept; each later answer drawn (every one with ``every`` 1,
    else each with chance 1/``every``, drawn from the seed) is compared in
    place with the kept answer of its input: an equal one adds a call to
    that answer's count, one that differs is kept itself.  Every answer
    drawn is judged, and memory holds distinct answers only."""

    def __init__(self, same, every: int, rng):
        self.same, self.every, self.rng = same, every, rng
        self.kept: list[list] = []  # [pool index, answer, calls]
        self.first: dict[int, list] = {}

    def add(self, k: int, out) -> None:
        first = self.first.get(k)
        if first is None:
            self.first[k] = [k, out, 1]
            self.kept.append(self.first[k])
        elif self.every == 1 or self.rng.random() * self.every < 1:
            if self.same(out, first[1]):
                first[2] += 1
            else:
                self.kept.append([k, out, 1])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _sync(ctx: Context) -> None:
    if ctx.device is None:
        import torch

        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def _card(ctx: Context) -> dict:
    if ctx.device is not None:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": ctx.chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(ctx.chips))}


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return "; ".join(out.stdout.split("\n")).strip("; ") or out.stderr


def _call_summary(calls, cpu_s: float, load: tuple) -> str:
    """The calls' times in ms: deciles, and the mean of each tenth of the
    window, to tell a slow stretch from slow calls spread throughout; the
    process's CPU seconds over the window's and the host's load average
    before and after, to tell waiting for a core from slower work."""
    ms = np.array([(t1 - t0) * 1e3 for t0, t1, _, _ in calls])
    tenths = [float(np.mean(p)) for p in np.array_split(ms, 10) if len(p)]
    window_s = max(c[1] for c in calls) - min(c[0] for c in calls)
    return (f"{len(ms)} calls, ms deciles "
            f"{np.percentile(ms, range(0, 101, 10)).round(2).tolist()}, "
            f"mean of each tenth {np.round(tenths, 2).tolist()}; "
            f"process CPU s / window s {cpu_s / window_s:.2f}; "
            f"load average {load[0]:.2f} -> {load[1]:.2f}")


def _host_probe() -> str:
    """A fixed piece of host work, timed: the host's speed of the moment
    (its cores and memory are shared), printed beside the window's times."""
    t = time.perf_counter()
    total = 0
    for i in range(200_000):
        total += i
    loop_ms = (time.perf_counter() - t) * 1e3
    a = np.ones(8 << 20, np.uint8)
    t = time.perf_counter()
    for _ in range(8):
        a = a.copy()
    copy_ms = (time.perf_counter() - t) * 1e3
    return f"python loop {loop_ms:.2f} ms, 64 MB of copies {copy_ms:.2f} ms"


def _caller(entry, state, items, window, span, answers, calls,
            counters, log):
    """``call(k, t_due=None)`` for the loop: one call of the entry on item
    ``k``, inside ``span`` when traced.  It appends (start, end, item,
    returned) to ``calls``, the start being ``t_due`` where the loop gives
    one, hands the answer to ``answers`` once its end is read, and appends
    the entry's counters after each call of a traced window; it returns
    whether the call returned an answer.  The first error is shown."""
    shown = []

    def call(k: int, t_due: float | None = None) -> bool:
        t0 = time.perf_counter()
        try:
            with window.span(span) if window else nullcontext():
                out = entry.call(state, items[k])
        except Exception:  # noqa: BLE001 -- counted, shown once, loop goes on
            if not shown:
                log(traceback.format_exc(), file=sys.stderr)
                shown.append(1)
            out = None
        calls.append((t0 if t_due is None else t_due, time.perf_counter(),
                      k, out is not None))
        if out is not None:
            answers.add(k, out)
        if window and hasattr(entry, "counters"):
            counters.append(entry.counters(state))
        return out is not None

    return call


def run(bench: Bench, name: str, seed: int, seconds: float, traced: bool,
        t_start: float, device: str | None = None, log=print,
        precision: str | None = None):
    """One run of cell ``name``; returns the result line's object, or
    ``None`` when a module of JAX or the JAX package was loaded by the time
    the result is ready (named through ``log``).  ``precision`` replaces
    the configuration's (the control, ``control.py``) while the reference
    keeps to the configuration."""
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    run_cfg = cfg if precision is None else dict(cfg, precision=precision)
    mix = bench.mix(cell["traffic"])
    sends = bench.sends(mix["sends"])
    loop = bench.loop(mix["loop"])
    entry = bench.entry(cell["entry"])
    wanted = bench.metrics_of(name, traced)
    ctx = Context(run_cfg, cell["chips"], device)

    marks = [("start", t_start), ("loaded", time.perf_counter())]
    pool = traffic.pool_inputs(cfg, seed, mix["pool"],
                               bench.generator(cfg["generator"]).image)
    items, ref_s, expected = sends.make(pool, cfg, mix)
    marks.append(("inputs", time.perf_counter()))
    state = entry.setup(ctx)
    marks.append(("entry set up", time.perf_counter()))
    for _ in range(WARM_ROUNDS):
        for item in items:
            entry.call(state, item)
        marks.append(("warm round", time.perf_counter()))
    _sync(ctx)
    setup_s = time.perf_counter() - t_start - ref_s
    log("set-up, seconds at each mark: " + ", ".join(
        f"{n} {t - t_start:.3f}" for n, t in marks[1:])
        + f"; the reference's {ref_s:.3f} of them left out of setup_s",
        file=sys.stderr)
    log(f"host probe before the window: {_host_probe()}", file=sys.stderr)

    window = tracing.Window(cuda=device is None) if traced else None
    answers = Answers(sends.same, mix["check_every"],
                      np.random.default_rng([seed % (1 << 64), 1]))
    calls, counters = [], []
    call = _caller(entry, state, items, window, cell["entry"], answers,
                   calls, counters, log)
    load0 = os.getloadavg()[0]
    if window:
        window.start()
    cpu0 = time.process_time()
    loop.run(call, len(items), seconds, mix)
    cpu_s = time.process_time() - cpu0
    events = window.stop() if window else None
    window_s = max(c[1] for c in calls) - min(c[0] for c in calls)

    log(_call_summary(calls, cpu_s, (load0, os.getloadavg()[0])),
        file=sys.stderr)
    log(f"host probe after the window: {_host_probe()}", file=sys.stderr)
    card = _card(ctx)
    timeline = None
    if events is not None:
        t = time.perf_counter()
        timeline = tracing.timeline(events, {cell["entry"]},
                                    list(range(ctx.chips)))
        del events
        log(f"trace reduced in {time.perf_counter() - t:.3f} s: "
            f"{tracing.summary(timeline)}", file=sys.stderr)
    del state, call
    gc.collect()
    if device is None:
        import torch

        torch.cuda.empty_cache()

    t = time.perf_counter()
    want, stream_bytes = expected()
    checks = sends.check(answers.kept, want)
    log(f"reference and comparison: {time.perf_counter() - t:.3f} s "
        f"({len(answers.kept)} distinct answers kept)", file=sys.stderr)
    raised = sum(not ok for *_, ok in calls)
    checks = {"calls_raised": raised, **checks}

    record = {
        "bench": bench, "cell": name, "kind": entry.KIND, "config": run_cfg,
        "card": card["kind"], "calls": calls, "window_s": window_s,
        "setup_s": setup_s,
        "megapixels": cfg["images_per_call"] * cfg["height"]
        * cfg["width"] / 1e6,
        "stream_bytes": stream_bytes,
        "timeline": timeline, "counters": counters,
    }
    metrics = {}
    for m in wanted:
        read = (bench.layer_metric if traced else bench.e2e_metric)(m["name"])
        value = read.read(record)
        if value is None:
            continue
        if not isinstance(value, dict):
            value = {"value": value}
        metrics[m["name"]] = {"value": value.pop("value"), "unit": m["unit"],
                              **value}

    if timeline is not None:
        busy, _ = tracing.busy_and_gaps(timeline)
        a, b = timeline["window"]
        card["busy_s"] = sum(busy.values()) / len(busy) / 1e9
        card["window_s"] = (b - a) / 1e9
    limits = compare.LIMITS
    failed = raised + checks.pop("calls_wrong")
    correct = failed == 0 and all(v <= limits[k] for k, v in checks.items())
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": card}
    if timeline is not None:
        result["breakdown"] = tracing.breakdown(timeline)
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    found = forbidden_modules()
    if found:
        log("forbidden modules loaded: " + ", ".join(found), file=sys.stderr)
        return None
    return result


def parse_args(argv):
    p = argparse.ArgumentParser(
        prog="portbench/run.py",
        description="One run of one cell of the port's benchmark.")
    p.add_argument("--workload", required=True, help="the cell's name")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True,
                   help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    bench = Bench()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"cell {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run(bench, args.workload, args.seed, args.seconds,
                 bool(args.trace), t_start)
    if result is None:
        return 3
    print(f"card and power limit: {_power_limit()}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
