"""Device ms per scan in VGGT's patch encoder: the work launched inside the
port's `estdepth::vggt_patch_embed` spans (models/vggt.py: DINOv2
ViT-L/14 on every frame: the patch convolution, the interpolated
position embedding, 24 blocks and the final LayerNorm), over the
requests delivered in the traced half. A port without the span gives
None."""

from portbench.harness.readings import device_ms_per


def read(r):
    return device_ms_per(r, "mvs_scan", {"estdepth::vggt_patch_embed"})
