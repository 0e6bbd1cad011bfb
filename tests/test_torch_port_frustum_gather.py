"""The tiled form of kernels 2 and 4 (csrc/frustum_gather.cuh), mirrored in
PyTorch on CPU and held to the plain versions bit for bit.

A block of either frustum warp owns a tile of kTileW x kTileH voxels of one
target plane (the sizes are read from the header). One lane per voxel loads
its coordinates, tests the mask (and kernel 2's z-window), applies the
corner rules and reads its four corners' plane indices q; the lanes that
store the voxel's vectors gather each corner's two taps at its own z0,
derive the corner's values (kernel 2: A and s; kernel 4: the hat-mixed M,
zero outside its window) in float32 and blend them in the kernels' order;
invalid voxels store zeros. The mirror below does the same per tile. It must
equal `resample_exact_z` and `plane_mix_resample_plain` bit for bit
(`torch.equal`) in float32 and bf16 (taps upcast, one rounding at the end)
at a translated pose, a rolled pose, a pose whose voxels leave the image
and one with the -2 sentinel behind the camera. It checks the order of
operations the CUDA body follows, not the CUDA body itself: the card tests
(tests/test_torch_port_cuda.py) hold the kernels to the plain versions.
On the CPU the voxel's z index divides by the depth interval as the plain
version does there; the kernel multiplies by the float32 reciprocal, as
PyTorch's division by a scalar does on the card. The mirror is also held
to the JAX package's Pallas functions (frustum_warp_exact_z_pallas,
frustum_warp_pallas) through the Pallas interpreter at in-plane
translations, where their two-pass sample is the exact one, at 1e-4: in
float32, and for a bf16 volume its float32 sum before the one rounding
against JAX on the same bf16 values (the TPU's bf16 kernels round their
intermediates: tests/test_torch_port_bf16.py).
"""

from __future__ import annotations

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.ops import warp as jwarp
from estdepth_tpu_torch.ops import warp
from estdepth_tpu_torch.ops.cuda import plane_mix
from estdepth_tpu_torch.ops.cuda.build import CSRC
from estdepth_tpu_torch.ops.sampling import corner
from estdepth_tpu_torch.ops.warp_exact_z import (
    EPS, resample_exact_z, zi_field,
)

from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
B, D, H, W, C = 2, 6, 12, 21, 16
DMIN, DMAX = 0.5, 8.0
DINT = (DMAX - DMIN) / (D - 1)


def _tile() -> tuple[int, int]:
    """(rows, columns) of a block's tile, from the header."""
    src = (CSRC / "frustum_gather.cuh").read_text()
    warps = int(re.search(r"kWarps = (\d+);", src).group(1))
    cols = int(re.search(r"kTileW = (\d+);", src).group(1))
    return warps * (32 // cols), cols


def _pose(tx=0.0, ty=0.0, tz=0.0, yaw=0.0, pitch=0.0, roll=0.0):
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    m = np.eye(4)
    m[:3, :3] = (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                 @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
                 @ np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]]))
    m[:3, 3] = [tx, ty, tz]
    return m.astype(np.float32)


def _intr(f=14.0):
    return np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]],
                    np.float32)


# poses of the two batch entries
POSES = {
    "translated": [_pose(tx=0.05, ty=-0.02, tz=0.03, pitch=-0.01),
                   _pose(tx=-0.04, ty=0.03, tz=-0.05, yaw=-0.015)],
    "rolled": [_pose(tx=0.05, tz=0.8, roll=0.5),
               _pose(ty=0.03, tz=0.6, roll=-0.6)],
    "leaving": [_pose(tx=0.6, ty=-0.3, yaw=0.2),
                _pose(tx=-0.5, tz=0.4, pitch=0.25)],
    "sentinel": [_pose(tx=0.3, tz=2.0, yaw=0.6, pitch=-0.3),
                 _pose(tx=-0.4, ty=0.3, tz=-1.5, yaw=-0.5, roll=0.3)],
}


def _inputs(poses, dtype, seed=0):
    rng = np.random.default_rng(seed)
    vol = torch.from_numpy(rng.normal(size=(B, D, H, W, C)).astype(
        np.float32)).to(dtype)
    k = torch.from_numpy(_intr())[None].expand(B, 3, 3)
    dv = torch.linspace(DMIN, DMAX, D)[None].expand(B, D)
    t, grid, x, y, z = warp.frustum_coords(torch.from_numpy(np.stack(poses)),
                                           k, dv, H, W)
    zi = zi_field(t, k, dv, DMIN, DINT, grid)
    return vol, zi, x, y, z


def _inside(x, y):
    return (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)


def _lerp(a, b, t):
    return a + t * (b - a)


class _ExactZ:
    """Kernel 2's corner values (A, s) and blend."""

    @staticmethod
    def z0(q):
        return torch.floor(q.clamp(0.0, D - 1.0)).clamp(0.0, max(D - 2.0,
                                                                 0.0))

    @staticmethod
    def values(v0, v1, q, z0):
        s = v1 - v0
        return [v0 - z0[:, None] * s, s]

    @staticmethod
    def voxel(x, y, z):
        zs = (z - DMIN) / DINT
        return (_inside(x, y) & (zs >= -EPS) & (zs <= D - 1.0 + EPS),
                zs.clamp(0.0, D - 1.0))

    @staticmethod
    def finish(t, zc):
        return t[0] + zc[:, None] * t[1]


class _PlaneMix:
    """Kernel 4's corner value M (hat-mixed, 0 outside its window) and
    blend."""

    @staticmethod
    def z0(q):
        return torch.floor(q).clamp(0.0, max(D - 2.0, 0.0))

    @staticmethod
    def values(v0, v1, q, z0):
        inside = ((q >= -EPS) & (q <= D - 1.0 + EPS))[:, None]
        w0 = (1.0 - (q - z0).abs()).clamp(min=0.0)[:, None]
        w1 = (1.0 - (q - (z0 + 1.0)).abs()).clamp(min=0.0)[:, None]
        m = w0 * v0 + w1 * v1
        return [torch.where(inside, m, torch.zeros_like(m))]

    @staticmethod
    def voxel(x, y, z):
        return _inside(x, y), None

    @staticmethod
    def finish(t, zc):
        return t[0]


OPS = {"exact_z": _ExactZ, "plane_mix": _PlaneMix}


def _tiled(kind, vol, zi, x, y, z, round_once=True):
    """The kernels' tiled form: per (plane, tile) each valid voxel's set-up,
    its corners' taps gathered at their own z0, their values and the blend.
    Returns the result in the volume's dtype (or, without `round_once`, its
    float32 sum)."""
    op = OPS[kind]
    tile_h, tile_w = _tile()
    p = B * D
    xs, ys, zs = (t.reshape(p, H * W) for t in (x, y, z))
    zmaps = zi.reshape(p, H * W)
    flat = vol.reshape(B, D, H * W, C)
    valid, zc = op.voxel(xs, ys, zs)
    x0, wx = corner(xs, W)
    y0, wy = corner(ys, H)
    offsets = (0, int(W > 1), int(H > 1) * W, int(H > 1) * W + int(W > 1))
    out = torch.zeros(p, H * W, C)
    for plane, ty, tx in itertools.product(range(p), range(-(-H // tile_h)),
                                           range(-(-W // tile_w))):
        rows = torch.arange(ty * tile_h, min((ty + 1) * tile_h, H))
        cols = torch.arange(tx * tile_w, min((tx + 1) * tile_w, W))
        vox = (rows[:, None] * W + cols[None]).reshape(-1)
        vox = vox[valid[plane, vox]]  # the others store zeros
        if not len(vox):
            continue
        b, zmap = plane // D, zmaps[plane]
        idx = y0[plane, vox] * W + x0[plane, vox]
        corners = []
        for off in offsets:
            q = zmap[idx + off]
            z0 = op.z0(q)
            v0 = flat[b, z0.long(), idx + off].float()
            v1 = flat[b, z0.long() + 1, idx + off].float()
            corners.append(op.values(v0, v1, q, z0))
        fx, fy = wx[plane, vox, None], wy[plane, vox, None]
        blended = [_lerp(_lerp(c00, c01, fx), _lerp(c10, c11, fx), fy)
                   for c00, c01, c10, c11 in zip(*corners)]
        out[plane, vox] = op.finish(
            blended, None if zc is None else zc[plane, vox])
    out = out.reshape(vol.shape)
    return out.to(vol.dtype) if round_once else out


def _plain(kind, vol, zi, x, y, z):
    if kind == "exact_z":
        return resample_exact_z(vol, zi, x, y, z, DMIN, DINT)
    return plane_mix.plane_mix_resample_plain(vol, zi, x, y)


@pytest.mark.parametrize("kind,dtype,pose", itertools.product(
    OPS, [torch.float32, torch.bfloat16], POSES))
def test_tiled_form_is_the_plain_version(kind, dtype, pose):
    vol, zi, x, y, z = _inputs(POSES[pose], dtype)
    got = _tiled(kind, vol, zi, x, y, z)
    want = _plain(kind, vol, zi, x, y, z)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    zero = (want == 0).all(-1)
    if pose == "leaving":  # voxels leave the image on both frames
        assert zero.reshape(B, -1).float().mean(-1).min() > 0.2
    if pose == "sentinel":
        assert (zi == -2).any()
    assert not zero.all()


@pytest.mark.parametrize("kind", OPS)
def test_tiled_form_matches_pallas(kind):
    """At in-plane translations (rows map to rows, so the TPU's two-pass
    sample is the exact one; both move along y, so that no row lands on
    the image border, where float noise flips the hard mask) the mirror is
    the JAX Pallas function within 1e-4; a bf16 volume's float32 sum
    against JAX on the same values in float32."""
    poses = [_pose(tx=-0.03, ty=0.05), _pose(tx=0.04, ty=-0.06)]
    mode = {"exact_z": "plane_mix_pallas_exact_z",
            "plane_mix": "plane_mix_pallas"}[kind]
    intr = _intr()[None]
    dv = np.linspace(DMIN, DMAX, D, dtype=np.float32)[None]
    for dtype in (torch.float32, torch.bfloat16):
        vol, zi, x, y, z = _inputs(poses, dtype)
        got = _tiled(kind, vol, zi, x, y, z, round_once=False)
        vol32 = vol.float().numpy()
        want = np.stack([np.asarray(jwarp.frustum_warp(
            jnp.asarray(vol32[i:i + 1]), poses[i][None], intr, dv, DMIN, DINT,
            mode=mode))[0] for i in range(B)])
        assert np.abs(want).max() > 1.0
        np.testing.assert_allclose(got.numpy(), want, rtol=0.0, atol=1e-4)
