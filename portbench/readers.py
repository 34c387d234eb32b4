"""What the metric readers share.  A reader (``e2e_metrics/<name>.py`` or
``layer_metrics/<name>.py``) has one function, ``read(record)``, which
returns the metric's value (a number, or a dict with ``value`` and further
keys), or ``None`` where the run holds nothing for it to read.

The record a run hands them:

- ``kind``: ``"encode"`` or ``"decode"`` (the entry's);
- ``calls``: (start, end, pool index, returned) of every call of the window,
  host clock, seconds;
- ``window_s``: from the first call to the return of the last;
- ``setup_s``, ``megapixels`` (true pixels a call, millions), ``config``,
  ``card`` (its name), ``stream_bytes`` (bytes of the streams of each pool
  input), ``bench`` (the loader);
- traced runs: ``timeline`` (``tracing.py``) and ``counters`` (what the
  entry's ``counters`` gave after each call).
"""

from __future__ import annotations

import numpy as np

from .tracing import busy_and_gaps

# device time that a pass's roofline share divides by: everything the card
# runs for the call but the copies between host and card
PASS_KINDS = {"kernel", "memset", "card_copy"}


def rate_mp_s(record, kind: str):
    """Megapixels of every call that returned, over the window's seconds."""
    if record["kind"] != kind:
        return None
    done = sum(1 for *_, ok in record["calls"] if ok)
    return done * record["megapixels"] / record["window_s"]


def p95_ms(record, kind: str):
    """The 95th percentile of all calls' times (linear interpolation)."""
    if record["kind"] != kind:
        return None
    ms = [(t1 - t0) * 1e3 for t0, t1, _, _ in record["calls"]]
    return float(np.percentile(ms, 95))


def _traced(record, kind: str):
    if record["kind"] != kind or record.get("timeline") is None:
        return None
    return record["timeline"]


def roofline(record, kind: str, pass_name: str):
    """The least time of the pass's own work (``work/<pass_name>.py``) at
    the card's datasheet peaks, summed over the calls that returned, as a
    share of the device time of every kernel, memset and on-card copy of the
    window, summed over the cards; ``bound`` names what sets the least
    time (``operations`` or ``bytes``) in most calls."""
    tl = _traced(record, kind)
    if tl is None:
        return None
    device_ns = sum(e - s for _, s, e, _, k in tl["device_ops"]
                    if k in PASS_KINDS)
    if device_ns <= 0:
        return None
    work = record["bench"].work(pass_name).work
    peaks = record["bench"].peaks(record["card"])
    least = 0.0
    by_ops = by_bytes = 0
    for _, _, k, ok in record["calls"]:
        if not ok:
            continue
        w = work(record["config"], record["stream_bytes"][k])
        t_bytes = w["bytes"] / peaks["hbm_bytes_s"]
        t_ops = w["flops"] / peaks[w["rate"]]
        least += max(t_bytes, t_ops)
        by_ops += t_ops >= t_bytes
        by_bytes += t_ops < t_bytes
    if least <= 0:
        return None
    return {"value": 100.0 * least / (device_ns / 1e9),
            "bound": "operations" if by_ops >= by_bytes else "bytes"}


def idle_pct(record, kind: str):
    """Share of the traced window in which a card ran nothing (no kernel,
    memset or copy), the mean over the cell's cards."""
    tl = _traced(record, kind)
    if tl is None:
        return None
    busy, _ = busy_and_gaps(tl)
    a, b = tl["window"]
    return 100.0 * (1.0 - sum(busy.values()) / len(busy) / (b - a))


def copy_ms(record, kind: str):
    """Device time of the copies between host and card a call, summed over
    the cards, milliseconds."""
    tl = _traced(record, kind)
    if tl is None:
        return None
    ns = sum(e - s for _, s, e, _, k in tl["device_ops"] if k == "host_copy")
    return ns / 1e6 / len(record["calls"])


def shard_seconds(record):
    """Per shard: (summed wall seconds, summed collective seconds) over the
    window's calls, from ``mesh.last_run``; ``None`` without a mesh."""
    runs = [c["last_run"] for c in record.get("counters") or []
            if c.get("last_run")]
    if not runs:
        return None
    n = len(runs[0])
    wall = [sum(r[i]["s"] for r in runs) for i in range(n)]
    coll = [sum(r[i]["collective_s"] for r in runs) for i in range(n)]
    return wall, coll
