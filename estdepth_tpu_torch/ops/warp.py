"""Plane-sweep and frustum (cost-volume) warps (port of
estdepth_tpu/ops/warp.py).

  * plane_sweep_warp <-> homo_warping (reference homo_utils.py:458-504)
  * frustum_warp     <-> warp_volume  (reference homo_utils.py:240-279),
    in three formulations named as in the JAX package: "exact" (one
    trilinear sample per voxel), "plane_mix" (z-mix per source pixel, then
    a bilinear sample per voxel) and "plane_mix_exact_z" (plane_mix with
    the slope-carry correction, ops/warp_exact_z.py)

The coordinate math is PyTorch. The plane-sweep sample and the two
plane_mix forms go through the kernel wrappers in ops/cuda/, which launch
the CUDA kernels on CUDA tensors and run their plain versions on CPU
tensors; there is no separate mode string for the kernel route. "exact"
is plain PyTorch on either device. `plane_sweep_warp(two_pass=True)`
samples through the fused two-pass resample (ops/cuda/two_pass.py), the
counterpart of the JAX package's `backend="pallas"` under
ESTDEPTH_FUSED_WARP=1, instead of the exact bilinear sample.

Gradients flow to the sampled features or volume only: the wrappers give
the coordinates none, as the JAX package's `custom_vjp`s do.

Inside `parallel.spatial.width_sharded` the maps and volumes given are one
rank's width shard. A sample lands anywhere in a row, so both warps gather
the sampled maps or volume whole (one all_gather), compute the coordinates
of this rank's own output columns only (the zi field of the frustum warps
on the whole source grid) and have the kernels write those columns:
coordinates [B, D, H, W_r] name an output window (ops/cuda/*.py), and
the two-pass route's line coefficients are those of the rank's global
columns.

Host waits (utils/trace.py): `host_wait.inverse` at each pose and
intrinsics inverse (ops/geometry.py), and the exact-z zi field's
`host_wait.solve` (ops/warp_exact_z.py).
"""

from __future__ import annotations

import torch

from estdepth_tpu_torch.ops import geometry
from estdepth_tpu_torch.ops.cuda.plane_mix import plane_mix_resample
from estdepth_tpu_torch.ops.cuda.plane_warp import plane_sweep_sample
from estdepth_tpu_torch.ops.cuda.plane_warp_exact_z import exact_z_resample
from estdepth_tpu_torch.ops.cuda.two_pass import (
    line_coeffs, two_pass_resample,
)
from estdepth_tpu_torch.ops.sampling import trilinear_sample
from estdepth_tpu_torch.ops.warp_exact_z import zi_field
from estdepth_tpu_torch.ops import shard_context

FRUSTUM_MODES = ("exact", "plane_mix", "plane_mix_exact_z")


def _plane_sweep_geometry(src_proj: torch.Tensor, ref_proj: torch.Tensor,
                          depth_values: torch.Tensor, height: int,
                          width: int, columns=None):
    """(rot, trans, x, y): rot [B, 3, 3] / trans [B, 3] of
    src_proj @ inv(ref_proj) (homo_utils.py:469-471) and the source pixel
    coordinates x, y [B, D*H*W] of every (plane, ref pixel), the projective
    division with +1e-8 (:483); with `columns` (start, stop) of the ref
    pixels of those columns only, [B, D*H*(stop-start)]. depth_values is
    [B, D], one depth a plane, or [B, D, H, W], D depth hypotheses of each
    ref pixel (CasMVSNet's cascade stages); a pixel's coordinates are the
    same arithmetic either way."""
    b, d = depth_values.shape[:2]
    rot, trans = geometry.relative_projection(src_proj, ref_proj)
    grid = geometry.pixel_grid(height, width, device=rot.device,
                               columns=columns)
    rot_xyz = torch.matmul(rot, grid)  # [B, 3, HW]
    if depth_values.dim() == 2:
        depth = depth_values[:, None, :, None]
    else:
        depth = depth_values.reshape(b, 1, d, -1)
    pts = rot_xyz[:, :, None, :] * depth
    pts = pts + trans[:, :, None, None]
    zb = pts[:, 2] + 1e-8
    x = (pts[:, 0] / zb).reshape(b, -1)
    y = (pts[:, 1] / zb).reshape(b, -1)
    return rot, trans, x, y


def plane_sweep_coords(src_proj: torch.Tensor, ref_proj: torch.Tensor,
                       depth_values: torch.Tensor, height: int, width: int):
    """Source pixel coordinates x, y [B, D*H*W] of every (plane, ref
    pixel)."""
    return _plane_sweep_geometry(src_proj, ref_proj, depth_values, height,
                                 width)[2:]


def plane_sweep_line_coeffs(rot: torch.Tensor, trans: torch.Tensor,
                            depth_values: torch.Tensor, width: int,
                            columns=None) -> torch.Tensor:
    """Line coefficients [B*D, 2, W] of the D plane homographies
    H_d = d * rot + trans e3^T of each map (homo_utils.py:469-483); with
    `columns` (start, stop) those of those target columns only,
    [B*D, 2, stop - start], bit for bit the whole call's columns."""
    hmat = depth_values[:, :, None, None].float() * rot.float()[:, None]
    hmat = torch.cat([hmat[..., :2],
                      hmat[..., 2:] + trans.float()[:, None, :, None]], -1)
    return line_coeffs(hmat.reshape(-1, 3, 3), width, columns)


def plane_sweep_warp(src_feat: torch.Tensor, src_proj: torch.Tensor,
                     ref_proj: torch.Tensor, depth_values: torch.Tensor,
                     two_pass: bool = False) -> torch.Tensor:
    """Warp src features [B, H, W, C] over the D fronto-parallel depth
    planes [B, D] of the ref camera, or over per-pixel depth hypotheses
    [B, D, H, W] of its pixels, -> [B, D, H, W, C]; out-of-view samples
    are 0. src_proj / ref_proj: [B, 4, 4] (geometry.camera_projection).
    `two_pass` samples through the fused two-pass resample (kernel 3)
    instead of the exact bilinear sample (kernel 1); it takes planes
    only, since its line coefficients are one homography a plane, and so
    does a width-sharded call."""
    b, h, w, c = src_feat.shape  # w: this rank's output columns
    d = depth_values.shape[1]
    shards = shard_context.current()
    if depth_values.dim() != 2:
        if depth_values.shape != (b, d, h, w):
            raise ValueError(f"per-pixel depth_values "
                             f"{tuple(depth_values.shape)} for features "
                             f"{tuple(src_feat.shape)}: [B, D, {h}, {w}]")
        if two_pass:
            raise ValueError("two_pass takes depth planes [B, D]: its line "
                             "coefficients are one homography a plane")
        if shards is not None:
            raise ValueError("a width-sharded sweep takes depth planes "
                             "[B, D]")
    columns = None
    if shards is not None:
        columns = shards.columns(w)
        src_feat = shards.gather_width(src_feat, 2)
    full = src_feat.shape[2]
    rot, trans, x, y = _plane_sweep_geometry(src_proj, ref_proj,
                                             depth_values, h, full, columns)
    if not two_pass:  # coordinates [B, D, H, w] name the output grid
        return plane_sweep_sample(src_feat, x.reshape(b, d, h, w),
                                  y.reshape(b, d, h, w))
    ab = plane_sweep_line_coeffs(rot, trans, depth_values, full, columns)
    out = two_pass_resample(src_feat, ab, x.reshape(b * d, h * w),
                            y.reshape(b * d, h * w), planes_per_map=d)
    return out.reshape(b, d, h, w, c)


def frustum_coords(rel_pose: torch.Tensor, cam_intr: torch.Tensor,
                   depth_values: torch.Tensor, height: int, width: int,
                   columns=None):
    """Target frustum voxels lifted and projected into the source view:
    returns (t, grid, x, y, z) with t = inv(rel_pose) the target->source
    transform, grid [3, HW], and x, y, z [B, D*H*W] (z is source depth);
    with `columns` (start, stop) the target voxels of those columns only:
    grid [3, H*(stop-start)] and x, y, z [B, D*H*(stop-start)]."""
    b = rel_pose.shape[0]
    grid = geometry.pixel_grid(height, width, device=rel_pose.device,
                               columns=columns)
    rays = geometry.backproject(cam_intr, grid)  # [B, 3, HW]
    pts = rays[:, :, None, :] * depth_values[:, None, :, None]
    t = geometry.inverse(rel_pose)
    pts = geometry.transform_points(t, pts)
    x, y, z = geometry.project_points(cam_intr, pts.reshape(b, 3, -1))
    return t, grid, x, y, z


def set_volume_border(volume: torch.Tensor,
                      border_value: float) -> torch.Tensor:
    """Every face voxel of [B, D, H, W, C] set to border_value
    (_set_vol_border, homo_utils.py:305-320)."""
    out = volume.clone()
    out[:, [0, -1]] = border_value
    out[:, :, [0, -1]] = border_value
    out[:, :, :, [0, -1]] = border_value
    return out


def frustum_warp(volume: torch.Tensor, rel_pose: torch.Tensor,
                 cam_intr: torch.Tensor, depth_values: torch.Tensor,
                 depth_min: float, depth_interval: float,
                 padding_mode: str = "zeros", padding_value: float = 0.0,
                 mode: str = "plane_mix_exact_z") -> torch.Tensor:
    """Resample a source-view frustum volume [B, D, H, W, C] into the
    target-view frustum.

    rel_pose [B, 4, 4] = src_pose @ inv(target_pose); cam_intr [B, 3, 3] at
    the volume's resolution; depth_values [B, D]. Out-of-range samples are
    0 with padding_mode "zeros"; "border" (mode "exact" only) clamps the
    coordinates against a border shell set to padding_value
    (homo_utils.py:271-275)."""
    if mode not in FRUSTUM_MODES:
        raise ValueError(f"unknown frustum_warp mode {mode!r}; one of "
                         f"{FRUSTUM_MODES}")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    if mode != "exact" and padding_mode != "zeros":
        raise ValueError(f"{mode} supports zeros padding only")
    shards = shard_context.current()
    columns = None
    if shards is not None:
        columns = shards.columns(volume.shape[3])
        volume = shards.gather_width(volume, 3)
    b, d, h, w, c = volume.shape
    t, grid, x, y, z = frustum_coords(rel_pose, cam_intr, depth_values, h, w,
                                      columns)
    out = (b, d, h, grid.shape[1] // h)  # the output grid
    if mode == "exact":
        zi = (z - depth_min) / depth_interval  # fractional source plane
        if padding_mode == "border":
            volume = set_volume_border(volume, padding_value)
            x = x.clamp(0.0, w - 1.0)
            y = y.clamp(0.0, h - 1.0)
            zi = zi.clamp(0.0, d - 1.0)
        return trilinear_sample(volume, x, y, zi).reshape(*out, c)
    if shards is not None:
        # the zi field lives on the whole source grid, and the coordinates
        # name this rank's output columns
        grid = geometry.pixel_grid(h, w, device=rel_pose.device)
        x, y, z = (q.reshape(out) for q in (x, y, z))
    zi = zi_field(t, cam_intr, depth_values, depth_min, depth_interval, grid)
    if mode == "plane_mix":
        return plane_mix_resample(volume, zi, x, y)
    return exact_z_resample(volume, zi, x, y, z, depth_min, depth_interval)
