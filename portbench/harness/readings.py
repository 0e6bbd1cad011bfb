"""What a per-layer reader is given, and the arithmetic readers share.

A `--trace 1` run splits its window in two halves. The first runs with the
host clock alone: its loop records (`host`, `host_window_s`) give the host
and rate metrics. The second runs under torch.profiler with the benchmark's
spans: `trace` (harness/trace.py) gives the device metrics. `flops` holds
the operations of each request kind, counted on the reference at the
cell's shapes. A reader returns None where it finds nothing to read, and
the harness then leaves its metric out.
"""

from __future__ import annotations

import dataclasses
import statistics

from portbench.harness.rooflines import PEAK_F32_FLOPS


@dataclasses.dataclass
class Readings:
    protocol: str
    host: list  # loop records of the first half
    host_window_s: float
    trace: object  # harness.trace.Trace of the second half
    flops: dict  # {request kind: operations}


def host_issue_ms(r: Readings, protocol: str) -> float | None:
    """Mean host ms from the call that issues a request to its return,
    before the fetch waits."""
    if r.protocol != protocol or not r.host:
        return None
    return 1e3 * statistics.fmean(x.t1 - x.t0 for x in r.host)


def mfu_percent(r: Readings, protocol: str) -> float | None:
    """100 x the reference's operations of the first half's requests over
    its seconds and the float32 peak."""
    if r.protocol != protocol or not r.host or not r.flops:
        return None
    ops = sum(r.flops[x.kind] for x in r.host)
    return 100.0 * ops / r.host_window_s / PEAK_F32_FLOPS


def idle_percent(r: Readings, protocol: str) -> float | None:
    """100 x (1 - the union of the device's activity over the traced
    half's length). The profiler's own host cost stretches a
    launch-bound loop, so on such a path this reads above the idle share
    of an untraced run."""
    if r.protocol != protocol or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def device_ms_per(r: Readings, protocol: str, names) -> float | None:
    """Device ms inside the spans of `names` per request that delivered in
    the traced half; None where no such span ran."""
    if r.protocol != protocol:
        return None
    done = sum(1 for x in r.trace.records if x.delivered)
    if not done or not any(s.name in names for s in r.trace.spans):
        return None
    return r.trace.span_device_ms(names) / done
