"""Device ms per scan in VGGT's global blocks: the work launched inside the
port's `estdepth::vggt_global` spans (models/vggt.py: the 24 global
blocks: attention over every frame's tokens at once, with its
LayerNorms, qkv, QK-norm, RoPE, the estdepth::attention op, the
projection and the MLP), over the requests delivered in the traced half.
A port without the span gives None."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "mvs_scan", {"estdepth::vggt_global"})
