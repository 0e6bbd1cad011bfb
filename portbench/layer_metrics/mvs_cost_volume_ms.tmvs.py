"""Device ms per reference view of TransMVSNet's cost volumes: the work
launched inside the port's `estdepth::mvs_cost_volume` spans
(models/transmvsnet.py, one a stage: the projections, per-pixel
hypotheses, the plane sweep of each source view through kernel 1, its
correlation with the reference, the view weights and their weighted
mean), over the views delivered in the traced half."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "mvs_views_wta", {"estdepth::mvs_cost_volume"})
