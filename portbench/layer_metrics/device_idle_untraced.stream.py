"""Share of a estm_stream run without the profiler in which the device
idles, in %: 100 x (1 - the device's busy ms of the work launched inside
the port's `estdepth::step` spans (ESTMRunner.push_frame) per frame
delivered in the traced half, over the untraced half's host-clock ms per
delivered frame). The fetch's copies to the host lie outside the spans."""

from portbench.harness.program_spans import untraced_idle_percent


def read(r):
    return untraced_idle_percent(r, "estm_stream")
