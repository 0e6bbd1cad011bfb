"""Image-space warps on the samplers (port of
estdepth_tpu/ops/image_warp.py; reference utils/homo_utils.py:208-237,
282-302).

Not on the model's path: the geometry API's inverse_warp and warp_depth,
channels-last [B, H, W, C] as in the JAX package, on ops/geometry.py and
the hard-edged ops/sampling.bilinear_sample. Each pose inverse runs
inside `host_wait.inverse` (ops/geometry.inverse).
"""

from __future__ import annotations

import torch

from estdepth_tpu_torch.ops import geometry
from estdepth_tpu_torch.ops.sampling import bilinear_sample


def _camera_points(depth: torch.Tensor, cam_intr: torch.Tensor):
    """Target pixels lifted by depth [B, H, W]: camera points [B, 3, HW]."""
    b, h, w = depth.shape
    grid = geometry.pixel_grid(h, w, device=depth.device)
    return geometry.backproject(cam_intr, grid) * depth.reshape(b, 1, -1)


def inverse_warp(feat: torch.Tensor, depth: torch.Tensor, pose: torch.Tensor,
                 cam_intr: torch.Tensor) -> torch.Tensor:
    """Sample source features feat [B, H, W, C] at the reprojections of the
    target pixels (homo_utils.py:208-237): lift them by the target depth
    [B, H, W], move them into the source frame with inverse(pose) (pose
    [B, 4, 4], source-to-target cam-to-world), project with cam_intr
    [B, 3, 3] and sample bilinearly. Returns [B, H, W, C]."""
    b, h, w = depth.shape
    pts = geometry.transform_points(geometry.inverse(pose),
                                    _camera_points(depth, cam_intr))
    x, y, _ = geometry.project_points(cam_intr, pts)
    return bilinear_sample(feat, x, y).reshape(b, h, w, feat.shape[-1])


def warp_depth(depth: torch.Tensor, rel_pose: torch.Tensor,
               cam_intr: torch.Tensor):
    """Depth of the reference pixels, depth [B, H, W], expressed in the
    source camera, rel_pose [B, 4, 4] = src_pose @ inv(ref_pose)
    (homo_utils.py:282-302). Returns (warped depth [B, H, W], valid
    [B, H, W]: the projection lands inside the image)."""
    b, h, w = depth.shape
    pts = geometry.transform_points(geometry.inverse(rel_pose),
                                    _camera_points(depth, cam_intr))
    x, y, z = geometry.project_points(cam_intr, pts)
    valid = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return z.reshape(b, h, w), valid.reshape(b, h, w)
