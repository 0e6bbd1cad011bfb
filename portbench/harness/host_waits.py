"""The host's waits on the card: the port's `estdepth::host_wait.<kind>`
spans (`estdepth_tpu_torch/utils/trace.py`), which it opens around each
call at which the host waits for the device's queue to drain (a copy from
pageable memory, a factorization that checks its result on the host).

The spans are profiler ranges on the device trace's clock, so the traced
half's `Trace` (harness/trace.py) holds them beside the device's merged
busy intervals. A wait's host time is the length of its outermost range
(a wait inside another counts once, in the outer one). The idle that
follows it is each gap between two busy intervals that begins while the
host is inside the wait: the device ran dry while the host waited, and
stays dry until the host's next launch reaches it. A gap that began
before the host entered the wait is not the wait's: the queue had drained
already. A checkout whose port opens no such span gives None, and so does
a trace with no device activity (a run on the CPU: there is no queue to
wait on).
"""

from __future__ import annotations

import bisect
import dataclasses

from portbench.harness.readings import Readings

WAIT = "estdepth::host_wait."


@dataclasses.dataclass(frozen=True)
class Wait:
    kind: str  # "upload", "inverse", ...
    within: str  # the innermost other `estdepth::` span it lies in, or ""
    host_us: float
    idle_us: float  # device idle in the gaps that began inside it


def waits(trace) -> list[Wait]:
    """Each outermost host wait of `trace`, in order of its start."""
    spans = sorted(trace.spans, key=lambda s: (s.start_us, -s.end_us))
    outer, enclosing, stack = [], [], []
    for s in spans:
        if s.name.startswith(WAIT):
            if outer and s.start_us < outer[-1].end_us:
                continue  # inside the previous wait
            while stack and stack[-1].end_us < s.start_us:
                stack.pop()
            outer.append(s)
            enclosing.append(stack[-1].name if stack else "")
        elif s.name.startswith("estdepth::"):
            while stack and stack[-1].end_us < s.start_us:
                stack.pop()
            stack.append(s)
    starts = [s.start_us for s in outer]
    idle = [0.0] * len(outer)
    for (_, gap_start), (gap_end, _) in zip(trace.busy, trace.busy[1:]):
        i = bisect.bisect_right(starts, gap_start) - 1
        if i >= 0 and gap_start <= outer[i].end_us:
            idle[i] += gap_end - gap_start
    return [Wait(s.name[len(WAIT):], within, s.end_us - s.start_us, us)
            for s, within, us in zip(outer, enclosing, idle)]


def _per_request(r: Readings, protocols, field: str) -> float | None:
    if r.protocol not in protocols or not r.trace.busy:
        return None
    found = waits(r.trace)
    done = sum(1 for x in r.trace.records if x.delivered)
    if not found or not done:
        return None
    return sum(getattr(w, field) for w in found) / 1e3 / done


def host_wait_ms(r: Readings, protocols) -> float | None:
    """Host ms inside the outermost `estdepth::host_wait.*` spans per
    request that delivered in the traced half; None for another protocol,
    without device activity or where no such span ran."""
    return _per_request(r, protocols, "host_us")


def wait_idle_ms(r: Readings, protocols) -> float | None:
    """Device idle ms, per request that delivered in the traced half, in
    the gaps between busy intervals that began inside an
    `estdepth::host_wait.*` span; None as `host_wait_ms`."""
    return _per_request(r, protocols, "idle_us")
