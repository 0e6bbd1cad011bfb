"""Device ms per reference view of CasMVSNet's cost volumes: the work
launched inside the port's `estdepth::mvs_cost_volume` spans
(models/casmvsnet.py, one a stage: the stage's projections, per-pixel
hypotheses, the plane sweep of each source view through kernel 1 and
the variance), over the views delivered in the traced half."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "mvs_views", {"estdepth::mvs_cost_volume"})
