"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips where no CUDA device is present (decided in
the fixture, not at import). On a machine with the card:

    python -m pytest tests/test_torch_port_cuda.py -m cuda

The three warp kernels repeat their plain version's arithmetic operation
by operation (no FMA contraction), so they are held to 1e-6 of the
output's scale; chip_smoke.py holds them to 1e-5 at the flagship shapes.
The attention kernel sums its 16 channels and its softmax in another order
than PyTorch's reductions, so it is held to rtol 1e-5 / atol 1e-6, the
tolerance the JAX package holds its TPU kernel to (tests/test_pallas.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from estdepth_tpu_torch.ops import geometry, warp
from estdepth_tpu_torch.ops.cuda import (
    epipolar_attention, plane_mix, plane_warp, plane_warp_exact_z,
)
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


def test_plane_mix_kernel_matches_plain(dev):
    b, h, w, d, c = 2, 24, 32, 16, 8
    k, poses, dv = _setup(dev, h, w, d, c, b)
    vol = torch.randn(b, d, h, w, c,
                      generator=torch.Generator().manual_seed(2)).to(dev)
    dint = (8.0 - 0.5) / (d - 1)
    t, grid, x, y, _ = warp.frustum_coords(poses, k, dv, h, w)
    zi = zi_field(t, k, dv, 0.5, dint, grid)
    before = plane_mix.KERNEL.launches
    got = plane_mix.plane_mix_resample(vol, zi, x, y)
    assert plane_mix.KERNEL.launches == before + 1
    _close(got, plane_mix.plane_mix_resample_plain(vol, zi, x, y))
    assert (got == 0).any() and (got != 0).any()
    # the same through the public warp
    _close(warp.frustum_warp(vol, poses, k, dv, 0.5, dint, mode="plane_mix"),
           got)
    assert plane_mix.KERNEL.launches == before + 2


def _attention_inputs(dev, b=2, n=3, d=4, h=6, w=8, c=16):
    gen = torch.Generator().manual_seed(3)
    warped = torch.randn(b, n, d, h, w, 2 * c, generator=gen).to(dev)
    tk = torch.randn(b, 2, d, h, w, c, generator=gen).to(dev)[:, 1]
    view = warped.transpose(0, 1)
    return tk, view[..., :c], view[..., c:]


@pytest.mark.parametrize("valid", [
    [[True, True], [True, True], [True, True]],
    [[True, False], [False, False], [True, False]],  # batch 1: none valid
    [[True, True], [False, True], [False, False]]])
def test_attention_kernel_matches_plain(dev, valid):
    """On the strided views the fusion hands over (K and V halves of one
    warped volume; a target key sliced out of a wider tensor)."""
    tk, wk, wv = _attention_inputs(dev)
    valid = torch.tensor(valid, device=dev).t().contiguous().t()  # [N, B]
    before = epipolar_attention.KERNEL.launches
    got = epipolar_attention.epipolar_attention(tk, wk, wv, valid)
    assert epipolar_attention.KERNEL.launches == before + 1
    want = epipolar_attention.epipolar_attention_plain(tk, wk, wv, valid)
    assert got.is_contiguous() and got.shape == tk.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for b in range(valid.shape[1]):
        if not valid[:, b].any():
            assert got[b].abs().max().item() == 0.0


def test_new_kernels_refuse_what_they_cannot_take(dev):
    vol = torch.zeros(1, 4, 6, 8, 8, device=dev)
    coords = torch.zeros(1, 4 * 6 * 8, device=dev)
    zi = torch.zeros(1, 4, 48, device=dev)
    with pytest.raises(TypeError):
        plane_mix.plane_mix_resample(vol.bfloat16(), zi, coords, coords)
    with pytest.raises(ValueError):  # C % 4
        plane_mix.plane_mix_resample(vol[..., :6].contiguous(), zi, coords,
                                     coords)
    with pytest.raises(ValueError, match="contiguous"):
        plane_mix.plane_mix_resample(vol[..., :4], zi, coords, coords)

    tk, wk, wv = _attention_inputs(dev)
    valid = torch.ones(3, 2, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        epipolar_attention.epipolar_attention(tk.bfloat16(), wk, wv, valid)
    with pytest.raises(ValueError, match="C == 16"):
        epipolar_attention.epipolar_attention(
            tk[..., :8], wk[..., :8], wv[..., :8], valid)
    with pytest.raises(ValueError, match="1 <= N <= 8"):
        epipolar_attention.epipolar_attention(
            tk, wk.repeat(3, 1, 1, 1, 1, 1), wv.repeat(3, 1, 1, 1, 1, 1),
            valid.repeat(3, 1))
    swapped = torch.zeros(2, 4, 6, 16, 8, device=dev).transpose(-1, -2)
    with pytest.raises(ValueError, match="channel stride"):
        epipolar_attention.epipolar_attention(swapped, wk, wv, valid)
    with pytest.raises(ValueError, match="differ"):
        epipolar_attention.epipolar_attention(tk, wk, wv.contiguous(), valid)
