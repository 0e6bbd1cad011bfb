"""Share of an mvs_views run without the profiler in which the device
idles, in %: 100 x (1 - the device's busy ms of the work launched inside
the port's `estdepth::step` spans (MVSRunner.run_view) per view
delivered in the traced half, over the untraced half's host-clock ms per
delivered view). The fetch's copies to the host lie outside the spans."""

from portbench.harness.program_spans import untraced_idle_percent


def read(r):
    return untraced_idle_percent(r, "mvs_views")
