"""Multi-view inference of the cascade networks, CasMVSNet
(models/casmvsnet.py) and TransMVSNet (models/transmvsnet.py), and of the
feed-forward VGGT (models/vggt.py), through one call. A cascade request is
a reference view and its sources: one reference depth map and its
confidence, as the published test scripts compute them for each view of
a scan before fusing them into a point cloud (cascade-stereo
CasMVSNet/test.py, TransMVSNet's test.py). A VGGT request is every frame
of a scan: a depth map and a confidence for each frame, and each frame's
camera; VGGT takes no cameras, so the poses and intrinsics are accepted
and not read, and it resizes the frames itself, on the device.

Spans (utils/trace.py): `step` around `run_view`; inside it
`host_wait.upload` around the request's copies to the device (pageable
host memory: on CUDA each waits for the device's queue to drain), and
the model's own.
"""

from __future__ import annotations

import torch

from estdepth_tpu_torch.config import resolve_device
from estdepth_tpu_torch.models.casmvsnet import MVSCascade
from estdepth_tpu_torch.models.vggt import VGGT
from estdepth_tpu_torch.utils import trace


class MVSRunner:
    """Runs the model on one request of views at a time. The model is
    moved to `device` (None: the CUDA device, raising when there is none)
    and kept in eval mode. `return_all` returns the model's whole output
    in place of the two maps: for a cascade also the final stage's plane
    index that the confidence is taken at, and each stage's depth; for
    VGGT also the logits and the pose encodings."""

    def __init__(self, model: MVSCascade | VGGT, return_all: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.return_all = return_all

    @trace.spanned("step")
    @torch.inference_mode()
    def run_view(self, imgs, cam_poses, intr):
        """imgs [B, V, H, W, 3] uint8 (or float in 0..255): for a cascade
        view 0 the reference and views 1.. its sources, for VGGT every
        frame of the scan, view 0 first; cam_poses [B, V, 4, 4]
        cam-to-world; intr [B, 3, 3] at full resolution (VGGT reads
        neither); numpy or tensors. Returns (depth, confidence) float32 on
        the device, [B, H, W] of the reference view for a cascade,
        [B, V, h, w] of every frame at VGGT's resized size; with
        `return_all` the model's output dict (models/casmvsnet.py:
        MVSCascade.forward, models/vggt.py: VGGT.forward)."""
        dev = self.device
        with trace.host_wait("upload"):
            imgs = torch.as_tensor(imgs).to(dev)
            cam_poses = torch.as_tensor(cam_poses).float().to(dev)
            intr = torch.as_tensor(intr).float().to(dev)
        out = self.model(imgs, cam_poses, intr)
        if self.return_all:
            return out
        return out["depth"], out["confidence"]
