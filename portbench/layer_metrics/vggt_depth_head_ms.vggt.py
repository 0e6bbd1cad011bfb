"""Device ms per scan in VGGT's depth head: the work launched inside the
port's `estdepth::vggt_depth_head` spans (models/vggt.py: the DPT depth
head on every frame, float32 with autocast off), over the requests
delivered in the traced half. A port without the span gives None."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "mvs_scan", {"estdepth::vggt_depth_head"})
