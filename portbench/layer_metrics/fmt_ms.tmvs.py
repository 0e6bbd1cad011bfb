"""Device ms per reference view of TransMVSNet's Feature Matching
Transformer: the work launched inside the port's `estdepth::mvs_fmt`
span (models/transmvsnet.py: the position encoding, the 36 layer passes
of a 5-view request and the top-down pathway), over the views delivered
in the traced half. A port without the span gives None."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "mvs_views_wta", {"estdepth::mvs_fmt"})
