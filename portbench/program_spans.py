"""What the readers of the program's own spans share.

The program records a span around each call and each stage of a call while
a torch profiler is on (``tinyimgcodec_tpu_torch.profiling.spans()``: its
records, on the profiler's clock, and the count it dropped).  A reader keeps
the records that start inside the traced window (which also tells apart the
runs made in one process), and charges each instant a card idles to the
innermost ``codec.<kind>.*`` stage then open on the thread of the shard that
drives it (shard r drives card r; 0 outside a mesh), or, where none is open,
to no stage ("unstaged": Python between stages, the call alone, between
calls).  Values are percent of the window, the mean over the cell's cards,
as ``readers.idle_pct`` computes the idle share: for each kind, the stages'
shares and the unstaged share add up to it.

Every function returns ``None`` where the run is untraced or of another
kind, where the program records no spans (an older program), where the
window holds none of the spans asked for, or where the program dropped
records that may lie inside the window.
"""

from __future__ import annotations

from collections import defaultdict

from .tracing import busy_and_gaps

UNSTAGED = ""


def window_spans(record, kind: str):
    """The program's span records that start inside the traced window of a
    run of ``kind``, or ``None``."""
    tl = record.get("timeline")
    if record["kind"] != kind or tl is None:
        return None
    from tinyimgcodec_tpu_torch import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    recs, dropped = read()
    a, b = tl["window"]
    # records are kept in the order they ended: every dropped one ended
    # before the oldest kept one, so none lies in the window if that one
    # ended before it
    if dropped and (not recs or recs[0].end_ns >= a):
        return None
    return [r for r in recs if a <= r.start_ns <= b]


def _pieces(stages):
    """(start, end, name) stage spans of one thread -> disjoint (start,
    end, name) pieces, each named after the innermost span open in it (the
    latest started; of two started at once, the one that ends first)."""
    stages = [st for st in stages if st[1] > st[0]]
    marks = sorted([(s, 1, -e, i) for i, (s, e, _) in enumerate(stages)]
                   + [(e, 0, 0, i) for i, (_, e, _) in enumerate(stages)])
    open_, pieces, last = [], [], None
    for t, starts, _, i in marks:
        if open_ and t > last:
            pieces.append((last, t, stages[open_[-1]][2]))
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
        last = t
    return pieces


def _charge(gaps, pieces) -> dict[str, int]:
    """ns of the sorted, disjoint ``gaps`` inside each named piece, and
    the rest under :data:`UNSTAGED`."""
    out = defaultdict(int)
    i = 0
    for gs, ge in gaps:
        while i < len(pieces) and pieces[i][1] <= gs:
            i += 1
        staged = 0
        j = i
        while j < len(pieces) and pieces[j][0] < ge:
            ns = min(ge, pieces[j][1]) - max(gs, pieces[j][0])
            if ns > 0:
                out[pieces[j][2]] += ns
                staged += ns
            j += 1
        out[UNSTAGED] += (ge - gs) - staged
    return out


def idle_by_stage(record, kind: str):
    """Percent of the window each card idles while its shard's host is in
    each ``codec.<kind>.<stage>`` span (keyed by ``<stage>``) or in none
    (:data:`UNSTAGED`), the mean over the cards; ``None`` as above, or when
    the window holds no stage span of ``kind``."""
    spans = window_spans(record, kind)
    prefix = f"codec.{kind}."
    stages = [r for r in spans or () if r.name.startswith(prefix)]
    if not stages:
        return None
    tl = record["timeline"]
    _, gaps = busy_and_gaps(tl)
    by_shard = defaultdict(list)
    for r in stages:
        by_shard[r.shard].append((r.start_ns, r.end_ns,
                                  r.name[len(prefix):]))
    total = dict.fromkeys(
        [UNSTAGED] + [r.name[len(prefix):] for r in stages], 0)
    for card, card_gaps in gaps.items():
        for name, ns in _charge(card_gaps,
                                _pieces(by_shard.get(card, []))).items():
            total[name] += ns
    a, b = tl["window"]
    scale = 100.0 / len(gaps) / (b - a)
    return {name: ns * scale for name, ns in total.items()}


def idle_in(record, kind: str, stage: str):
    """The idle share charged to stage ``stage`` (:data:`UNSTAGED`: to
    none), as a reader's dict; ``None`` when the window holds no such
    span."""
    shares = idle_by_stage(record, kind)
    if shares is None or stage not in shares:
        return None
    return {"value": shares[stage]}


def per_call(record, kind: str, name: str, count: str):
    """The mean over the window's calls of ``count`` summed over a call's
    ``name`` spans (over its shards, say); ``None`` where none has it."""
    spans = window_spans(record, kind)
    calls = defaultdict(int)
    for r in spans or ():
        if r.name == name and count in r.counts:
            calls[r.call_id] += r.counts[count]
    if not calls:
        return None
    return sum(calls.values()) / len(calls)


def decode_leg_share(record, leg: str):
    """100 x the images decode leg ``leg`` took over the images of the
    window's ``codec.decompress_batch`` spans (their leg counts)."""
    spans = window_spans(record, "decode")
    legs = defaultdict(int)
    for r in spans or ():
        if r.name == "codec.decompress_batch":
            for k in ("kernel", "host_entropy", "host_decoder"):
                legs[k] += r.counts.get(k, 0)
    images = sum(legs.values())
    if not images:
        return None
    return 100.0 * legs[leg] / images
