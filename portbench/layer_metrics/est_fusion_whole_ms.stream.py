"""Device ms per ESTM frame of the whole EST fusion: the work launched
inside the port's `estdepth::est_fusion` spans
(DepthHybridDecoder._est_fusion_sequential), the pose inverses, stacks and
the warp's coordinate arithmetic included, over the frames delivered in
the traced half."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "estm_stream", {"estdepth::est_fusion"})
