"""Bilinear and trilinear sampling with hard out-of-range zeroing (port of
estdepth_tpu/ops/sampling.py:bilinear_sample_stacked and
trilinear_sample_stacked).

A sample point is valid iff x in [0, W-1] and y in [0, H-1]
(align_corners=True pixel coordinates); valid points are interpolated from
in-bounds corners, invalid points are exactly zero (homo_utils.py:484-501).
The corner rules are the JAX stacked samplers', which the CUDA kernels
reproduce: clip the coordinate to [0, size-1], the base index to
[0, size-2], take the fraction against the clipped coordinate, and zero
by the UNCLIPPED coordinate.

A bfloat16 (or float16) volume is sampled in float32 and the result
rounded once to its dtype (round to nearest even), as the kernels' bf16
instances do; a float32 or float64 volume is sampled in its own dtype.
The coordinates and fractions are float32 for every dtype.

`F.grid_sample` is not used: its zeros padding fades each out-of-range
corner separately, which differs from the hard rule at the edges.
"""

from __future__ import annotations

import torch

_HALF = (torch.bfloat16, torch.float16)


def upcast_half(src: torch.Tensor) -> torch.Tensor:
    """src in the dtype it is sampled in: float32 for a half dtype."""
    return src.float() if src.dtype in _HALF else src


def corner(q: torch.Tensor, size: int):
    """Base index (int64) and fraction of coordinate q along an axis."""
    qc = q.clamp(0.0, size - 1.0)
    i0 = torch.floor(qc).clamp(0.0, max(size - 2.0, 0.0))
    return i0.long(), qc - i0


def bilinear_sample(src: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample src [B, H, W, C] at pixel coords x, y [B, N] -> [B, N, C]
    in src's dtype."""
    b, h, w, c = src.shape
    dtype, src = src.dtype, upcast_half(src)
    x = x.float()
    y = y.float()
    valid = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    x0, wx = corner(x, w)
    y0, wy = corner(y, h)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    flat = src.reshape(b, h * w, c)

    def gather(iy, ix):
        idx = (iy * w + ix)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx)

    wx = wx[..., None].to(src.dtype)
    wy = wy[..., None].to(src.dtype)
    v00, v01 = gather(y0, x0), gather(y0, x1)
    v10, v11 = gather(y1, x0), gather(y1, x1)
    top = v00 + wx * (v01 - v00)
    bot = v10 + wx * (v11 - v10)
    out = top + wy * (bot - top)
    return (out * valid[..., None].to(src.dtype)).to(dtype)


def trilinear_sample(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     z: torch.Tensor) -> torch.Tensor:
    """Sample src [B, D, H, W, C] at voxel coords x, y, z [B, N]
    -> [B, N, C] in src's dtype; zero unless x in [0, W-1], y in
    [0, H-1], z in [0, D-1]. The x lerp is innermost, then y, then z, as in
    the stacked sampler."""
    b, d, h, w, c = src.shape
    dtype, src = src.dtype, upcast_half(src)
    x, y, z = x.float(), y.float(), z.float()
    valid = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
             & (z >= 0) & (z <= d - 1))
    x0, wx = corner(x, w)
    y0, wy = corner(y, h)
    z0, wz = corner(z, d)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    z1 = (z0 + 1).clamp(max=d - 1)
    flat = src.reshape(b, d * h * w, c)

    def gather(iz, iy, ix):
        idx = ((iz * h + iy) * w + ix)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx)

    wx = wx[..., None].to(src.dtype)
    wy = wy[..., None].to(src.dtype)
    wz = wz[..., None].to(src.dtype)

    def plane(iz):
        v00, v01 = gather(iz, y0, x0), gather(iz, y0, x1)
        v10, v11 = gather(iz, y1, x0), gather(iz, y1, x1)
        top = v00 + wx * (v01 - v00)
        bot = v10 + wx * (v11 - v10)
        return top + wy * (bot - top)

    front, back = plane(z0), plane(z1)
    out = front + wz * (back - front)
    return (out * valid[..., None].to(src.dtype)).to(dtype)
