"""The comparison that decides ``correct``: the answers the timed calls
returned against the plain reference's, exactly.

Each number compared has the limit 0 (exact mode promises the float64
oracle's bytes and pixels); ``PERF.md`` gives the readings each was checked
against.  ``kept`` is a list of (pool index, answer, calls) of the answers
compared: ``calls`` is how many calls of the window gave that answer (the
harness holds an answer once and counts the calls equal to it).
"""

from __future__ import annotations

import numpy as np

LIMITS = {"calls_raised": 0, "streams_wrong": 0, "pixels_wrong": 0}


def same_streams(a, b) -> bool:
    return len(a) == len(b) and all(bytes(x) == bytes(y)
                                    for x, y in zip(a, b))


def same_pixels(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


def streams(kept, expected: list[list[bytes]]) -> dict:
    """Encode: a stream counts as wrong unless it equals the reference's
    byte for byte at its place; a missing or extra stream counts too."""
    wrong = calls_wrong = 0
    for k, out, calls in kept:
        exp = expected[k]
        out = list(out)
        n = max(len(out), len(exp))
        bad = sum(1 for i in range(n)
                  if i >= len(out) or i >= len(exp)
                  or bytes(out[i]) != exp[i])
        wrong += bad * calls
        calls_wrong += (bad > 0) * calls
    return {"streams_wrong": wrong, "calls_wrong": calls_wrong}


def pixels(kept, expected: list[np.ndarray]) -> dict:
    """Decode: every pixel that differs from the reference's counts; an
    answer of another shape counts all the reference's pixels."""
    wrong = calls_wrong = 0
    for k, out, calls in kept:
        exp = expected[k]
        out = np.asarray(out)
        if out.shape != exp.shape:
            bad = exp.size
        else:
            bad = int(np.count_nonzero(out != exp))
        wrong += bad * calls
        calls_wrong += (bad > 0) * calls
    return {"pixels_wrong": wrong, "calls_wrong": calls_wrong}
