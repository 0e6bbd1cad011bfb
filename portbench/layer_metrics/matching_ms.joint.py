"""Device ms per Joint window of the matching encoder (PSM or SENet): the
kernels inside the `DepthNetHybrid.matchingFeature` spans, over the
windows of the traced half."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "joint_window", {"portbench::matchingFeature"})
