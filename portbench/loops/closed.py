"""A closed loop of one caller: each call starts when the one before it has
returned, on the next item of the pool in turn, until ``seconds`` have
passed since the loop began.

A loop file has ``KEYS`` (the mix parameters it reads) and ``run(call,
n_items, seconds, mix)``, which calls ``call(k)`` or ``call(k, t_due)``
(``t_due``: the host-clock time the request arrived, where the loop gives
one; a call's latency runs from it) from one or more threads; ``call``
times the call, keeps its answer and returns whether it returned one.
"""

import time

KEYS = set()


def run(call, n_items, seconds, mix):
    deadline = time.perf_counter() + seconds
    n = 0
    while n == 0 or time.perf_counter() < deadline:
        call(n % n_items)
        n += 1
