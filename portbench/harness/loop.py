"""The closed loop that every protocol's window runs, and the host clock.

A protocol's session hands out requests one by one; the loop times each
from the call that issues it (`t0`) to the return of that call, when the
host has queued the request's work (`t1`), and to the end of its fetch,
when its results are on the host (`t2`). The next request is issued only
after that: one client, a closed loop. The window closes with the first
request that ends past `seconds`; every metric is taken over all requests
and all the time of the window.
"""

from __future__ import annotations

import dataclasses
import os
import time


@dataclasses.dataclass(frozen=True)
class Rec:
    kind: str  # the request's kind, for its operation count
    delivered: int  # results the request delivered (maps, targets, steps)
    t0: float
    t1: float
    t2: float


def closed_loop(session, seconds: float, span=None):
    """Run session requests for `seconds`: (records, window seconds).
    `span(name)` returns a context manager opened around each issue and
    fetch (a profiler range in the traced half), or None."""
    recs = []
    start = time.perf_counter()
    end = start + seconds
    while True:
        req = session.next_request()
        t0 = time.perf_counter()
        if span is None:
            pending = session.issue(req)
            t1 = time.perf_counter()
            delivered = session.fetch(req, pending)
        else:
            with span("portbench::issue"):
                pending = session.issue(req)
            t1 = time.perf_counter()
            with span("portbench::fetch"):
                delivered = session.fetch(req, pending)
        t2 = time.perf_counter()
        recs.append(Rec(req.kind, delivered, t0, t1, t2))
        if t2 >= end:
            return recs, t2 - start


def process_age_s() -> float:
    """Seconds since this process started, by the kernel's record of its
    start (/proc/self/stat, field 22, in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start
