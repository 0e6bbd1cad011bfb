"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips where no CUDA device is present (decided in
the fixture, not at import). On a machine with the card:

    python -m pytest tests/test_torch_port_cuda.py -m cuda

Both kernels repeat their plain version's arithmetic operation by
operation (no FMA contraction), so they are held to 1e-6 of the output's
scale; chip_smoke.py holds them to 1e-5 at the flagship shapes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from estdepth_tpu_torch.ops import geometry, warp
from estdepth_tpu_torch.ops.cuda import plane_warp, plane_warp_exact_z
from estdepth_tpu_torch.ops.warp_exact_z import resample_exact_z, zi_field

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pose(tx, ty, tz, yaw, pitch):
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                 @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]))
    m[:3, 3] = [tx, ty, tz]
    return torch.from_numpy(m)


def _setup(dev, h=24, w=32, d=16, c=8, b=2):
    k = torch.tensor([[[30.0, 0, (w - 1) / 2], [0, 30.0, (h - 1) / 2],
                       [0, 0, 1]]], device=dev).expand(b, 3, 3)
    poses = torch.stack([_pose(0.05, -0.02, 0.03, 0.02, -0.01),
                         _pose(-0.04, 0.03, -0.05, -0.015, 0.02)]).to(dev)
    dv = torch.linspace(0.5, 8.0, d, device=dev)[None].expand(b, d)
    return k, poses, dv


def _close(got, want):
    scale = want.abs().max().item()
    assert scale > 0
    assert (got - want).abs().max().item() <= 1e-6 * scale


def test_plane_sweep_kernel_matches_plain(dev):
    b, h, w, d, c = 2, 24, 32, 16, 8
    k, poses, dv = _setup(dev, h, w, d, c, b)
    src = torch.randn(b, h, w, c, generator=torch.Generator().manual_seed(0))
    src = src.to(dev)
    proj = geometry.camera_projection(k, poses)
    ref = geometry.camera_projection(k, torch.eye(4, device=dev).expand(
        b, 4, 4))
    x, y = warp.plane_sweep_coords(proj, ref, dv, h, w)
    before = plane_warp.KERNEL.launches
    got = plane_warp.plane_sweep_sample(src, x, y)
    assert plane_warp.KERNEL.launches == before + 1
    _close(got, plane_warp.plane_sweep_sample_plain(src, x, y))
    assert (got == 0).any() and (got != 0).any()


def test_exact_z_kernel_matches_plain(dev):
    b, h, w, d, c = 2, 24, 32, 16, 8
    k, poses, dv = _setup(dev, h, w, d, c, b)
    vol = torch.randn(b, d, h, w, c,
                      generator=torch.Generator().manual_seed(1)).to(dev)
    dint = (8.0 - 0.5) / (d - 1)
    t, grid, x, y, z = warp.frustum_coords(poses, k, dv, h, w)
    zi = zi_field(t, k, dv, 0.5, dint, grid)
    before = plane_warp_exact_z.KERNEL.launches
    got = plane_warp_exact_z.exact_z_resample(vol, zi, x, y, z, 0.5, dint)
    assert plane_warp_exact_z.KERNEL.launches == before + 1
    _close(got, resample_exact_z(vol, zi, x, y, z, 0.5, dint))


def test_kernels_refuse_bf16_and_bad_shapes(dev):
    vol = torch.zeros(1, 4, 6, 8, 8, device=dev)
    coords = torch.zeros(1, 4 * 6 * 8, device=dev)
    zi = torch.zeros(1, 4, 48, device=dev)
    with pytest.raises(TypeError):
        plane_warp_exact_z.exact_z_resample(vol.bfloat16(), zi, coords,
                                            coords, coords, 0.5, 0.1)
    with pytest.raises(ValueError):
        plane_warp_exact_z.exact_z_resample(vol[..., :6].contiguous(), zi,
                                            coords, coords, coords, 0.5, 0.1)
    with pytest.raises(ValueError):
        plane_warp.plane_sweep_sample(vol[0, 0], coords[:, :-1],
                                      coords[:, :-1])
