"""Multi-view stereo inference of the cascade networks, CasMVSNet
(models/casmvsnet.py) and TransMVSNet (models/transmvsnet.py): one
reference depth map and its confidence per request, as the published
test scripts compute them for each view of a scan before fusing them
into a point cloud (cascade-stereo CasMVSNet/test.py, TransMVSNet's
test.py).
"""

from __future__ import annotations

import torch

from estdepth_tpu_torch.config import resolve_device
from estdepth_tpu_torch.models.casmvsnet import MVSCascade
from estdepth_tpu_torch.utils import trace


class MVSRunner:
    """Runs the model on one request of views at a time. The model is
    moved to `device` (None: the CUDA device, raising when there is none)
    and kept in eval mode. `return_all` returns the model's whole output
    in place of the two maps: also the final stage's plane index that
    the confidence is taken at, and each stage's depth."""

    def __init__(self, model: MVSCascade, return_all: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.return_all = return_all

    @trace.spanned("step")
    @torch.inference_mode()
    def run_view(self, imgs, cam_poses, intr):
        """imgs [B, V, H, W, 3] uint8 (or float in 0..255), view 0 the
        reference and views 1.. its sources; cam_poses [B, V, 4, 4]
        cam-to-world; intr [B, 3, 3] at full resolution; numpy or tensors.
        Returns (depth, confidence) [B, H, W] float32 on the device, or
        with `return_all` the model's output dict (models/casmvsnet.py:
        MVSCascade.forward)."""
        dev = self.device
        imgs = torch.as_tensor(imgs).to(dev)
        cam_poses = torch.as_tensor(cam_poses).float().to(dev)
        intr = torch.as_tensor(intr).float().to(dev)
        out = self.model(imgs, cam_poses, intr)
        if self.return_all:
            return out
        return out["depth"], out["confidence"]
