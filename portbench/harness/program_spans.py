"""The idle share that the port's own spans give
(`estdepth_tpu_torch/utils/trace.py`).

The port opens `estdepth::<name>` profiler ranges only while a profiler
records, so they reach the traced half's `Trace` (harness/trace.py) like
the op ranges, on the device trace's clock. A checkout whose port opens
none gives None here.
"""

from __future__ import annotations

from portbench.harness.readings import Readings, device_ms_per

STEP = "estdepth::step"


def untraced_idle_percent(r: Readings, protocol: str) -> float | None:
    """100 x (1 - the device's busy ms of the work launched inside the
    `estdepth::step` spans per request delivered in the traced half, over
    the untraced half's host-clock ms per delivered request). The profiler
    stretches the host's gaps far more than the kernels, so the traced busy
    time of a request over the untraced wall time of one is the idle share
    of a run without the profiler; where the device is busy throughout,
    the profiler's smaller cost on the kernels themselves reads as a share
    a few % below 0. Kernels can overlap on the card (in a PSM Joint window
    on the H100 the summed kernel time exceeds their union by about a
    fifth), so the spans' share of the summed device time is taken of the
    union, `busy_s`."""
    step_ms = device_ms_per(r, protocol, {STEP})
    summed_s = sum(e - s for _, s, e in r.trace.device) / 1e6
    done = sum(1 for x in r.host if x.delivered)
    if step_ms is None or summed_s <= 0 or not done or r.host_window_s <= 0:
        return None
    busy_ms = step_ms * r.trace.busy_s / summed_s
    return 100.0 * (1.0 - busy_ms / (1e3 * r.host_window_s / done))
