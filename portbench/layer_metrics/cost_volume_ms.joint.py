"""Device ms per Joint window of the cost volume: the work launched inside
the port's `estdepth::cost_volume` spans (DepthNetHybrid._cost_volumes:
the projections, the plane sweep, the concat and pre0-pre2), over the
windows of the traced half."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "joint_window", {"estdepth::cost_volume"})
