"""The port's two-pass resample (plain version of kernel 3) against the JAX
package's fused two-pass Pallas kernel on CPU.

The JAX side is estdepth_tpu.ops.pallas.plane_warp._two_pass with
ESTDEPTH_FUSED_WARP=1 (the kernel the port's CUDA kernel replaces), run
through the Pallas interpreter as tests/test_pallas_warp.py runs it. The
inputs are made with numpy from a seed and handed to both. Tolerance
1e-4 x scale; measured 1.7e-6 x scale (the JAX package holds its split
form to the fused one at 3e-6).

The CUDA kernel computes each output voxel directly from four gathers of
its source map, with no pass-1 image (csrc/two_pass_resample.cu). A
PyTorch mirror of that form is held here to the plain version bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.ops import geometry as jgeo
from estdepth_tpu.ops import warp as jwarp
from estdepth_tpu.ops.pallas import plane_warp as jpw
from estdepth_tpu_torch.ops import warp as twarp
from estdepth_tpu_torch.ops.cuda import two_pass
from estdepth_tpu_torch.ops.sampling import corner

from test_torch_port_common import (  # noqa: F401
    one_torch_thread, training_test_env,
)

pytestmark = pytest.mark.usefixtures("training_test_env")
H, W, C, D = 12, 20, 8, 6


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _pose(tx=0.0, ty=0.0, tz=0.0, yaw=0.0, pitch=0.0):
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    m = np.eye(4)
    m[:3, :3] = (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                 @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]))
    m[:3, 3] = [tx, ty, tz]
    return m[None].astype(np.float32)


def _homographies(rng, p):
    """Near-identity homographies with shifts, shear and perspective, so
    lines cross rows and some samples leave the image."""
    hm = np.tile(np.eye(3, dtype=np.float32), (p, 1, 1))
    hm += rng.normal(size=(p, 3, 3)).astype(np.float32) * [
        [0.08, 0.08, 3.0], [0.08, 0.08, 2.0], [1e-3, 1e-3, 0.02]]
    return hm.astype(np.float32)


def _exact_xy(hm):
    """The exact source (x, y) of every target pixel under hm [P, 3, 3]:
    [P, H*W] each, row-major."""
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = np.stack([u.ravel(), v.ravel(), np.ones(H * W)]).astype(np.float32)
    q = hm @ pix  # [P, 3, HW]
    return (q[:, 0] / q[:, 2]).astype(np.float32), (
        q[:, 1] / q[:, 2]).astype(np.float32)


def _jax_two_pass(src, ab, x, y, planes_per_map):
    """JAX layouts: maps [M, H, C, W], yq / xv [P, W, Hout]."""
    p = ab.shape[0]
    maps_t = jnp.transpose(jnp.asarray(src), (0, 1, 3, 2))
    yq = jnp.transpose(jnp.asarray(y).reshape(p, H, W), (0, 2, 1))
    xv = jnp.transpose(jnp.asarray(x).reshape(p, H, W), (0, 2, 1))
    return np.asarray(jpw._two_pass(maps_t, jnp.asarray(ab), yq, xv,
                                    planes_per_map=planes_per_map))


@pytest.mark.parametrize("planes_per_map", [1, D])
def test_two_pass_plain_matches_fused_pallas(monkeypatch, planes_per_map):
    monkeypatch.setenv("ESTDEPTH_FUSED_WARP", "1")
    rng = np.random.default_rng(3)
    m = 2
    p = m * planes_per_map
    src = rng.normal(size=(m, H, W, C)).astype(np.float32)
    hm = _homographies(rng, p)
    x, y = _exact_xy(hm)
    want_ab = np.asarray(jpw._line_coeffs(jnp.asarray(hm), W))
    got_ab = two_pass.line_coeffs(_t(hm), W).numpy()
    np.testing.assert_allclose(got_ab, want_ab, rtol=1e-5, atol=1e-5)

    want = _jax_two_pass(src, want_ab, x, y, planes_per_map)
    got = two_pass.two_pass_resample_plain(
        _t(src), _t(want_ab), _t(x), _t(y), planes_per_map).numpy()
    assert got.shape == want.shape == (p, H, W, C)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-4 * scale)
    # the scene has both samples inside and hard-masked samples outside
    assert (want == 0).all(-1).any() and (want != 0).all(-1).any()
    # on CPU tensors the wrapper runs the plain version
    wrapped = two_pass.two_pass_resample(_t(src), _t(want_ab), _t(x), _t(y),
                                         planes_per_map).numpy()
    np.testing.assert_array_equal(wrapped, got)


@pytest.mark.parametrize("pose,exact_atol", [
    (_pose(tx=0.05), 5e-4), (_pose(ty=-0.04, tz=0.08), 5e-4),
    (_pose(tx=0.04, ty=-0.03, tz=0.06, yaw=0.015, pitch=-0.01), 2e-2)])
def test_plane_sweep_two_pass_matches_pallas_backend(monkeypatch, pose,
                                                     exact_atol):
    """`plane_sweep_warp(two_pass=True)` is the JAX package's
    backend="pallas" under ESTDEPTH_FUSED_WARP=1 at 1e-4 x scale, and
    within the Pallas function's own distance from the exact sample
    (tests/test_pallas_warp.py: 5e-4 translations, 2e-2 rotations)."""
    monkeypatch.setenv("ESTDEPTH_FUSED_WARP", "1")
    rng = np.random.default_rng(7)
    h, w, c, d = 16, 20, 8, 16
    feat = rng.normal(size=(1, h, w, c)).astype(np.float32)
    intr = np.array([[[18.0, 0, (w - 1) / 2], [0, 18.0, (h - 1) / 2],
                      [0, 0, 1]]], np.float32)
    dvals = np.linspace(0.5, 8.0, d, dtype=np.float32)[None]
    ref_proj = jgeo.camera_projection(intr, _pose())
    src_proj = jgeo.camera_projection(intr, pose)
    want = np.asarray(jwarp.plane_sweep_warp(feat, src_proj, ref_proj, dvals,
                                             backend="pallas"))
    args = (_t(feat), _t(src_proj), _t(ref_proj), _t(dvals))
    got = twarp.plane_sweep_warp(*args, two_pass=True).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-4 * scale)
    exact = twarp.plane_sweep_warp(*args).numpy()
    np.testing.assert_allclose(got, exact, rtol=0.0, atol=exact_atol)


def test_two_pass_refuses_what_it_cannot_take():
    src = torch.zeros(2, 4, 6, 8)
    ab = torch.zeros(6, 2, 6)
    xy = torch.zeros(6, 24)
    with pytest.raises(ValueError, match="planes_per_map"):
        two_pass.two_pass_resample(src, ab, xy, xy, 2)
    with pytest.raises(ValueError, match="planes_per_map"):
        two_pass.two_pass_resample(src[:, :1], ab, xy[:, :6], xy[:, :6], 3)
    with pytest.raises(ValueError, match="unsupported device"):
        two_pass.two_pass_resample(src.to("meta"), ab.to("meta"),
                                   xy.to("meta"), xy.to("meta"), 3)


def _four_gathers(src, ab, x, y, planes_per_map):
    """The kernel's form of the two passes: output (p, i, w) from rows y0
    and y0 + 1 of column w of the pass-1 image, each computed from two
    gathers of the source map, with the kernel's operations in its order."""
    m, h, w, c = src.shape
    p = ab.shape[0]
    flat = src.reshape(m, h * w, c).repeat_interleave(planes_per_map, 0)
    x, y = x.reshape(p, h, w), y.reshape(p, h, w)
    valid = (y >= 0) & (y <= h - 1) & (x >= 0) & (x <= w - 1)
    y0, f2 = corner(y, h)
    a, b = ab[:, 0, None, :], ab[:, 1, None, :]

    def mix(g0, g1, f):
        return g0 * (1.0 - f[..., None]) + g1 * f[..., None]

    def row(r):  # the pass-1 value at row r of each voxel's column
        x0, f = corner(a * r.float() + b, w)
        idx = (r * w + x0).reshape(p, h * w, 1).expand(-1, -1, c)
        g0, g1 = torch.gather(flat, 1, idx), torch.gather(flat, 1, idx + 1)
        return mix(g0, g1, f.reshape(p, h * w))

    out = mix(row(y0), row(y0 + 1), f2.reshape(p, h * w))
    out = torch.where(valid.reshape(p, h * w, 1), out, torch.zeros_like(out))
    return out.reshape(p, h, w, c)


def _rotations(rng, p, h, w, angle):
    """Rotations about the image centre by about `angle`, shifted by a
    fifth of the image and with a little perspective: source lines cross
    rows, and some leave the image."""
    cx, cy = (w - 1) / 2, (h - 1) / 2
    out = []
    for _ in range(p):
        t = angle * (1.0 + 0.5 * rng.standard_normal())
        rot = np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0],
                        [0, 0, 1]])
        move = np.array([[1, 0, cx + 0.2 * w * rng.standard_normal()],
                         [0, 1, cy + 0.2 * h * rng.standard_normal()],
                         [0, 0, 1]])
        back = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]])
        hm = move @ rot @ back
        hm[2, :2] += 2e-3 * rng.standard_normal(2)
        out.append(hm)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("m,planes_per_map,h,w,c,angle", [
    (2, 1, 12, 20, 4, 0.1), (2, 5, 12, 21, 32, -0.15),
    (1, 3, 2, 9, 4, 0.05), (3, 2, 7, 33, 32, 0.3), (2, 4, 2, 2, 4, 0.0)])
def test_four_gather_form_is_the_two_passes(m, planes_per_map, h, w, c,
                                            angle):
    rng = np.random.default_rng(11)
    p = m * planes_per_map
    src = _t(rng.normal(size=(m, h, w, c)))
    hm = _rotations(rng, p, h, w, angle)
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([u.ravel(), v.ravel(), np.ones(h * w)]).astype(np.float32)
    q = hm @ pix
    x, y = _t(q[:, 0] / q[:, 2]), _t(q[:, 1] / q[:, 2])
    ab = two_pass.line_coeffs(_t(hm), w)
    want = two_pass.two_pass_resample_plain(src, ab, x, y, planes_per_map)
    got = _four_gathers(src, ab, x, y, planes_per_map)
    assert torch.equal(got, want)
    # voxels inside and outside, and pass-1 lines that leave the image
    assert (want == 0).all(-1).any() and (want != 0).all(-1).any()
    line = ab[:, 0, None, :] * torch.arange(h)[None, :, None] + ab[:, 1, None,
                                                                  :]
    assert ((line < 0) | (line > w - 1)).any()
