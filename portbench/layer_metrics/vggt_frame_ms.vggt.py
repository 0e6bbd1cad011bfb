"""Device ms per scan in VGGT's frame blocks: the work launched inside the
port's `estdepth::vggt_frame` spans (models/vggt.py: the 24 frame
blocks: the same block, attending within each frame), over the requests
delivered in the traced half. A port without the span gives None."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "mvs_scan", {"estdepth::vggt_frame"})
