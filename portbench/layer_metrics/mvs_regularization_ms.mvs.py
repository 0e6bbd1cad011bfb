"""Device ms per reference view of CasMVSNet's 3D regularization: the work
launched inside the port's `estdepth::mvs_regularization` spans
(models/casmvsnet.py, one a stage: the stage's 3D U-Net, CostRegNet),
over the views delivered in the traced half."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "mvs_views", {"estdepth::mvs_regularization"})
