"""Device ms per ESTM frame of EST fusion: the kernels inside the
`CostRegNet.epipolar_transformer` spans (attention and ConvGRU) and the
`estdepth::exact_z_resample` op ranges (the frustum warp of the
neighbours' key/value volumes, kernel 2), over the frames delivered in the
traced half. The warp's coordinate arithmetic runs outside both."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "estm_stream", {
        "portbench::epipolar_transformer", "estdepth::exact_z_resample"})
