"""Device ms per reference view of TransMVSNet's 3D regularization: the
work launched inside the port's `estdepth::mvs_regularization` spans (one
a stage: the stage's 3D U-Net, CostRegNet(1, 8)), over the views
delivered in the traced half."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "mvs_views_wta",
                         {"estdepth::mvs_regularization"})
