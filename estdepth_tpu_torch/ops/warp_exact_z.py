"""Exact-z plane-mix frustum warp, plain PyTorch (port of
estdepth_tpu/ops/warp_exact_z.py; its module doc has the derivation).

Per output voxel p with source coordinates (x, y) and exact source plane
index zi*(p), and per bilinear corner pixel c with its own plane index
zi(c) (from `zi_field`):

  z0(c) = clip(floor(clip(zi(c), 0, Z-1)), 0, Z-2)
  s(c)  = V[z0+1, c] - V[z0, c]        A(c) = V[z0, c] - z0(c) * s(c)
  out(p) = (A~ + clip(zi*, 0, Z-1) * s~) * valid_xy * valid_z(zi*)

where ~ is the bilinear blend of the four corners. This is the plain
version of the CUDA kernel in ops/cuda/plane_warp_exact_z.py, which
computes the same per-voxel sum without materializing A and s.
"""

from __future__ import annotations

import torch

from estdepth_tpu_torch.ops.sampling import bilinear_sample

EPS = 1e-3  # z-window epsilon of the plane-mix family (ops/warp.py)


def zi_field(t: torch.Tensor, cam_intr: torch.Tensor,
             depth_values: torch.Tensor, depth_min: float,
             depth_interval: float, grid: torch.Tensor) -> torch.Tensor:
    """Fractional source-plane index of each target plane at each SOURCE
    pixel: zi [B, D, HW], with a -2.0 sentinel behind the camera.

    Target plane d is {A_d p} in the source frame with A_d = dv_d R K^-1
    (+ translation in the last column); its source depth at source pixel q
    is 1 / (n_d . K^-1 q) where A_d^T n_d = e3."""
    b, d = depth_values.shape
    rot = t[:, :3, :3]
    trans = t[:, :3, 3]
    k_inv = torch.linalg.inv(cam_intr)
    m0 = torch.matmul(rot, k_inv)
    a = depth_values[:, :, None, None].float() * m0[:, None]
    a = torch.cat([a[..., :2], a[..., 2:] + trans[:, None, :, None]], -1)
    e3 = torch.zeros(b, d, 3, 1, dtype=a.dtype, device=a.device)
    e3[:, :, 2] = 1.0
    n = torch.linalg.solve(a.transpose(-1, -2), e3)[..., 0]  # [B, D, 3]
    rays = torch.matmul(k_inv, grid)  # [B, 3, HW]
    denom = torch.matmul(n, rays)  # [B, D, HW]
    zi = (1.0 / denom - depth_min) / depth_interval
    in_front = (denom > 1e-8) & torch.isfinite(zi)
    return torch.where(in_front, zi, torch.full_like(zi, -2.0))


def tap_and_slope_fields(volume: torch.Tensor, zi: torch.Tensor):
    """A and s per source pixel and target plane.

    volume [B, Z, H, W, C]; zi [B, D, HW] -> (a, s) f32 [B, D, HW, C].
    The corner plane index is clamped into range, never zeroed; validity
    is decided per voxel in `apply_exact_z_correction`."""
    b, z, h, w, c = volume.shape
    z0 = torch.floor(zi.clamp(0.0, z - 1.0)).clamp(0.0, max(z - 2.0, 0.0))
    z0i = z0.long()
    src = volume.float().reshape(b, z, h * w, c)
    hw = torch.arange(h * w, device=volume.device)
    bi = torch.arange(b, device=volume.device)[:, None, None]
    v0 = src[bi, z0i, hw]
    v1 = src[bi, z0i + 1, hw]
    s = v1 - v0
    return v0 - z0[..., None] * s, s


def apply_exact_z_correction(a_t: torch.Tensor, s_t: torch.Tensor,
                             zi_star: torch.Tensor, nplanes: int,
                             out_dtype,
                             z_origin: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """out = A~ + (clip(zi*) - z_origin) s~, zeroed outside the eps-padded
    z window, computed in float32 and cast to out_dtype.

    a_t, s_t [P, N, C] resampled fields; zi_star [P, N]; z_origin [P] the
    per-map index origin the A field was extrapolated to
    (A = v0 + (z_origin - z0) s), default 0 as `tap_and_slope_fields`
    makes it. A shifted origin is the same function in exact arithmetic
    and keeps |A| near the volume's scale: the JAX package's packed bf16
    TPU transport builds A that way."""
    zc = zi_star.clamp(0.0, nplanes - 1.0)
    if z_origin is not None:
        zc = zc - z_origin.float()[:, None]
    out = a_t.float() + zc[..., None] * s_t.float()
    valid = (zi_star >= -EPS) & (zi_star <= nplanes - 1.0 + EPS)
    return (out * valid[..., None].float()).to(out_dtype)


def resample_exact_z(volume: torch.Tensor, zi: torch.Tensor,
                     x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                     depth_min: float, depth_interval: float) -> torch.Tensor:
    """The exact-z resample given the zi field: volume [B, D, H, W, C],
    zi [B, D, HW], exact source x, y and DEPTH z [B, D*H*W]
    -> [B, D, H, W, C], or x, y, z [B, D, H, Wo] (a window of output
    columns) -> [B, D, H, Wo, C]. Plain version of kernel 2."""
    b, d, h, w, c = volume.shape
    a, s = tap_and_slope_fields(volume, zi)
    asx = torch.cat([a, s], -1).reshape(b * d, h, w, 2 * c)
    as_t = bilinear_sample(asx, x.reshape(b * d, -1), y.reshape(b * d, -1))
    zi_star = ((z.float() - depth_min) / depth_interval).reshape(b * d, -1)
    out = apply_exact_z_correction(as_t[..., :c], as_t[..., c:], zi_star, d,
                                   volume.dtype)
    return out.reshape(b, d, h, -1, c)


def frustum_warp_exact_z(volume: torch.Tensor, t: torch.Tensor,
                         cam_intr: torch.Tensor, depth_values: torch.Tensor,
                         depth_min: float, depth_interval: float,
                         grid: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                         z: torch.Tensor) -> torch.Tensor:
    """Exact-z plane-mix frustum resample, plain PyTorch; same arguments as
    the JAX `frustum_warp_exact_z` (t: target->source transform)."""
    zi = zi_field(t, cam_intr, depth_values, depth_min, depth_interval, grid)
    return resample_exact_z(volume, zi, x, y, z, depth_min, depth_interval)
