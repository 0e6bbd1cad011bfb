"""Plane-sweep and frustum (cost-volume) warps (port of
estdepth_tpu/ops/warp.py).

  * plane_sweep_warp <-> homo_warping (reference homo_utils.py:458-504)
  * frustum_warp     <-> warp_volume  (reference homo_utils.py:240-279),
    in the "plane_mix_exact_z" formulation (ops/warp_exact_z.py)

The coordinate math is PyTorch; the sampling goes through the kernel
wrappers in ops/cuda/, which launch the CUDA kernels on CUDA tensors and
run their plain versions on CPU tensors.
"""

from __future__ import annotations

import torch

from estdepth_tpu_torch.ops import geometry
from estdepth_tpu_torch.ops.cuda.plane_warp import plane_sweep_sample
from estdepth_tpu_torch.ops.cuda.plane_warp_exact_z import exact_z_resample
from estdepth_tpu_torch.ops.warp_exact_z import zi_field


def plane_sweep_coords(src_proj: torch.Tensor, ref_proj: torch.Tensor,
                       depth_values: torch.Tensor, height: int, width: int):
    """Source pixel coordinates x, y [B, D*H*W] of every (plane, ref pixel):
    rot/trans of src_proj @ inv(ref_proj) (homo_utils.py:469-471) and the
    projective division with +1e-8 (:483)."""
    b, d = depth_values.shape
    rot, trans = geometry.relative_projection(src_proj, ref_proj)
    grid = geometry.pixel_grid(height, width, device=rot.device)
    rot_xyz = torch.matmul(rot, grid)  # [B, 3, HW]
    pts = rot_xyz[:, :, None, :] * depth_values[:, None, :, None]
    pts = pts + trans[:, :, None, None]
    zb = pts[:, 2] + 1e-8
    x = (pts[:, 0] / zb).reshape(b, -1)
    y = (pts[:, 1] / zb).reshape(b, -1)
    return x, y


def plane_sweep_warp(src_feat: torch.Tensor, src_proj: torch.Tensor,
                     ref_proj: torch.Tensor,
                     depth_values: torch.Tensor) -> torch.Tensor:
    """Warp src features [B, H, W, C] over the D fronto-parallel depth
    planes [B, D] of the ref camera -> [B, D, H, W, C]; out-of-view samples
    are 0. src_proj / ref_proj: [B, 4, 4] (geometry.camera_projection)."""
    _, h, w, _ = src_feat.shape
    x, y = plane_sweep_coords(src_proj, ref_proj, depth_values, h, w)
    return plane_sweep_sample(src_feat, x, y)


def frustum_coords(rel_pose: torch.Tensor, cam_intr: torch.Tensor,
                   depth_values: torch.Tensor, height: int, width: int):
    """Target frustum voxels lifted and projected into the source view:
    returns (t, grid, x, y, z) with t = inv(rel_pose) the target->source
    transform, grid [3, HW], and x, y, z [B, D*H*W] (z is source depth)."""
    b = rel_pose.shape[0]
    grid = geometry.pixel_grid(height, width, device=rel_pose.device)
    rays = geometry.backproject(cam_intr, grid)  # [B, 3, HW]
    pts = rays[:, :, None, :] * depth_values[:, None, :, None]
    t = torch.linalg.inv(rel_pose)
    pts = geometry.transform_points(t, pts)
    x, y, z = geometry.project_points(cam_intr, pts.reshape(b, 3, -1))
    return t, grid, x, y, z


def frustum_warp(volume: torch.Tensor, rel_pose: torch.Tensor,
                 cam_intr: torch.Tensor, depth_values: torch.Tensor,
                 depth_min: float, depth_interval: float,
                 mode: str = "plane_mix_exact_z") -> torch.Tensor:
    """Resample a source-view frustum volume [B, D, H, W, C] into the
    target-view frustum, zeros padding.

    rel_pose [B, 4, 4] = src_pose @ inv(target_pose); cam_intr [B, 3, 3] at
    the volume's resolution; depth_values [B, D]. Only the eval tools'
    default mode, "plane_mix_exact_z", is ported; "exact" and "plane_mix"
    raise NotImplementedError."""
    if mode != "plane_mix_exact_z":
        raise NotImplementedError(
            f"frustum_warp mode {mode!r} is not ported; only "
            f"'plane_mix_exact_z' is"
        )
    _, _, h, w, _ = volume.shape
    t, grid, x, y, z = frustum_coords(rel_pose, cam_intr, depth_values, h, w)
    zi = zi_field(t, cam_intr, depth_values, depth_min, depth_interval, grid)
    return exact_z_resample(volume, zi, x, y, z, depth_min, depth_interval)
