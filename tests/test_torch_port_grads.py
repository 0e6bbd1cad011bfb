"""The gradients of the port's kernel wrappers against the JAX package's
`custom_vjp`s on CPU.

Each JAX Pallas entry is forward-only; its backward is XLA's VJP of the
plain formulation with respect to the sampled volume at the same
coordinates, with zero cotangents for everything else. The port's wrappers
do the same. Here the same numpy inputs and one seeded cotangent go
through `jax.vjp` of the Pallas entry (interpret mode) and through
autograd of the port's public warp on CPU tensors: volume gradients within
1e-5 x scale (measured 3.4e-6 or less), and no gradient for poses,
intrinsics or coordinates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.ops import geometry as jgeo
from estdepth_tpu.ops import warp as jwarp
from estdepth_tpu_torch.ops import warp as twarp
from estdepth_tpu_torch.ops.cuda import (
    epipolar_attention, plane_mix, plane_warp, plane_warp_exact_z, two_pass,
)
from estdepth_tpu_torch.ops.warp_exact_z import zi_field

from test_torch_port_common import (  # noqa: F401
    one_torch_thread, training_test_env,
)

pytestmark = pytest.mark.usefixtures("training_test_env")
H, W, C, D = 12, 16, 4, 8
DMIN, DMAX = 0.5, 8.0
DINT = (DMAX - DMIN) / (D - 1)


def _t(a, grad=False):
    return torch.from_numpy(
        np.asarray(a, dtype=np.float32).copy()).requires_grad_(grad)


def _pose(tx, ty, tz, yaw, pitch):
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    m = np.eye(4)
    m[:3, :3] = (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                 @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]))
    m[:3, 3] = [tx, ty, tz]
    return m[None].astype(np.float32)


POSE = _pose(0.04, -0.03, 0.06, 0.015, -0.01)
INTR = np.array([[[14.0, 0, (W - 1) / 2], [0, 14.0, (H - 1) / 2],
                  [0, 0, 1]]], np.float32)
DVALS = np.linspace(DMIN, DMAX, D, dtype=np.float32)[None]


def _assert_grad_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0.0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("two_pass_route", [False, True])
def test_plane_sweep_gradient_matches_pallas_vjp(two_pass_route):
    """Kernel 1's and the two-pass kernel's wrappers: both backward
    through the exact bilinear sample, as `_psweep_bwd` does."""
    rng = np.random.default_rng(11)
    feat = rng.normal(size=(1, H, W, C)).astype(np.float32)
    ct = rng.normal(size=(1, D, H, W, C)).astype(np.float32)
    ref_proj = np.asarray(jgeo.camera_projection(INTR, _pose(0, 0, 0, 0, 0)))
    src_proj = np.asarray(jgeo.camera_projection(INTR, POSE))
    _, vjp = jax.vjp(lambda f: jwarp.plane_sweep_warp(
        f, src_proj, ref_proj, DVALS, backend="pallas"), jnp.asarray(feat))
    (want,) = vjp(jnp.asarray(ct))

    f_t = _t(feat, grad=True)
    projs = [_t(src_proj, grad=True), _t(ref_proj, grad=True)]
    out = twarp.plane_sweep_warp(f_t, *projs, _t(DVALS),
                                 two_pass=two_pass_route)
    out.backward(_t(ct))
    _assert_grad_close(f_t.grad, want)
    assert all(p.grad is None for p in projs)


@pytest.mark.parametrize("mode,jax_mode", [
    ("plane_mix_exact_z", "plane_mix_pallas_exact_z"),
    ("plane_mix", "plane_mix_pallas")])
def test_frustum_gradient_matches_pallas_vjp(mode, jax_mode):
    """Kernels 2 and 4: the wrappers' volume gradient is the JAX Pallas
    entries' (XLA VJP of the exact-z and the plane-mix formulation)."""
    rng = np.random.default_rng(12)
    vol = rng.normal(size=(1, D, H, W, C)).astype(np.float32)
    ct = rng.normal(size=vol.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jwarp.frustum_warp(
        v, POSE, INTR, DVALS, DMIN, DINT, mode=jax_mode), jnp.asarray(vol))
    (want,) = vjp(jnp.asarray(ct))

    v_t = _t(vol, grad=True)
    pose_t, intr_t = _t(POSE, grad=True), _t(INTR, grad=True)
    out = twarp.frustum_warp(v_t, pose_t, intr_t, _t(DVALS), DMIN, DINT,
                             mode=mode)
    out.backward(_t(ct))
    _assert_grad_close(v_t.grad, want)
    assert pose_t.grad is None and intr_t.grad is None


def test_wrappers_give_coordinates_no_gradient():
    """Called directly with coordinate tensors that require grad: the
    volume gets its gradient, the coordinates none."""
    rng = np.random.default_rng(13)
    vol = _t(rng.normal(size=(1, D, H, W, C)), grad=True)
    pose, intr, dv = _t(POSE), _t(INTR), _t(DVALS)
    t, grid, x, y, z = twarp.frustum_coords(pose, intr, dv, H, W)
    zi = zi_field(t, intr, dv, DMIN, DINT, grid)
    coords = [c.clone().requires_grad_() for c in (zi, x, y, z)]
    plane_warp_exact_z.exact_z_resample(vol, *coords, DMIN, DINT).sum(
    ).backward()
    plane_mix.plane_mix_resample(vol, *coords[:3]).sum().backward()
    src = _t(rng.normal(size=(1, H, W, C)), grad=True)
    plane_warp.plane_sweep_sample(src, coords[1], coords[2]).sum().backward()
    ab = torch.zeros(D, 2, W, requires_grad=True)
    two_pass.two_pass_resample(src, ab, coords[1].reshape(D, -1),
                               coords[2].reshape(D, -1), D).sum().backward()
    assert vol.grad is not None and src.grad is not None
    assert all(c.grad is None for c in (*coords, ab))


def test_attention_kernel_route_has_no_gradient():
    """The attention kernel is forward-only, like the TPU kernel: its
    launch check refuses a tensor that requires grad, and training with
    use_fused_attention raises before any work."""
    from estdepth_tpu_torch.config import ModelConfig
    from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
    from estdepth_tpu_torch.ops.cuda import build

    tk = torch.zeros(1, 2, 3, 4, 16, requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        build.require_voxel_rows(tk, "target_key", tk.shape, tk.device)
    # the plain version, which training runs, is differentiable
    wk = torch.ones(2, 1, 2, 3, 4, 16)
    out = epipolar_attention.epipolar_attention_plain(
        tk, wk, wk, torch.ones(2, 1, dtype=torch.bool))
    out.sum().backward()
    assert tk.grad is not None
    model = DepthNetHybrid(ModelConfig(ndepths=4, resnet=18,
                                       use_fused_attention=True))
    with pytest.raises(ValueError, match="forward-only"):
        model(torch.zeros(1, 3, 32, 32, 3), torch.eye(4).expand(1, 3, 4, 4),
              torch.eye(3)[None], train=True)
    assert not model.training
