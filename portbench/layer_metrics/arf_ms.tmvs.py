"""Device ms per reference view of TransMVSNet's Adaptive Receptive Field:
the work launched inside the port's `estdepth::mvs_arf` span
(models/transmvsnet.py: the three modulated deformable convolutions of
every view's FPN maps, their offsets and masks), over the views delivered
in the traced half. A port without the span gives None."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "mvs_views_wta", {"estdepth::mvs_arf"})
