"""The port's geometry, sampler and warps against the JAX package on CPU.

The same numpy inputs go through estdepth_tpu (the reference) and
estdepth_tpu_torch; on CPU tensors the port's kernel wrappers run their
plain PyTorch versions, which is what is held here. The Pallas functions
run through the Pallas interpreter, as the JAX package's own tests run
them. Tolerances are those the JAX tests hold each function to
(tests/test_pallas_warp.py, tests/test_exact_z_warp.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.ops import geometry as jgeo
from estdepth_tpu.ops import sampling as jsampling
from estdepth_tpu.ops import warp as jwarp
from estdepth_tpu.ops import warp_exact_z as jez
from estdepth_tpu_torch.ops import geometry as tgeo
from estdepth_tpu_torch.ops import sampling as tsampling
from estdepth_tpu_torch.ops import warp as twarp
from estdepth_tpu_torch.ops import warp_exact_z as tez
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DMIN, DMAX, ND = 0.5, 8.0, 16
DINT = (DMAX - DMIN) / (ND - 1)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else (
        np.asarray(a))


def _pose(tx=0.0, ty=0.0, tz=0.0, yaw=0.0, pitch=0.0):
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    m = np.eye(4)
    m[:3, :3] = ry @ rx
    m[:3, 3] = [tx, ty, tz]
    return m[None].astype(np.float32)


TRANSLATIONS = [_pose(), _pose(tx=0.05), _pose(ty=-0.04, tz=0.08)]
ROTATIONS = [_pose(tx=0.04, ty=-0.03, tz=0.06, yaw=0.015, pitch=-0.01),
             _pose(tz=0.2, yaw=0.03)]


def _intr(h, w, f):
    return np.array([[[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]]],
                    np.float32)


def _dv(d=ND, lo=DMIN, hi=DMAX):
    return np.linspace(lo, hi, d, dtype=np.float32)[None]


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    k = _intr(12, 16, 20.0)
    pose = _pose(tx=0.1, ty=-0.05, tz=0.2, yaw=0.1, pitch=0.05)
    pose2 = _pose(tx=-0.3, yaw=-0.2)
    grid_j = jgeo.pixel_grid(12, 16)
    grid_t = tgeo.pixel_grid(12, 16)
    np.testing.assert_array_equal(_np(grid_t), np.asarray(grid_j))
    pairs = [
        (tgeo.scale_intrinsics(_t(k), 0.25), jgeo.scale_intrinsics(k, 0.25)),
        (tgeo.camera_projection(_t(k), _t(pose)),
         jgeo.camera_projection(k, pose)),
        (tgeo.backproject(_t(k), grid_t), jgeo.backproject(k, grid_j)),
    ]
    rot_t, trans_t = tgeo.relative_projection(
        tgeo.camera_projection(_t(k), _t(pose)),
        tgeo.camera_projection(_t(k), _t(pose2)))
    rot_j, trans_j = jgeo.relative_projection(
        jgeo.camera_projection(k, pose), jgeo.camera_projection(k, pose2))
    pairs += [(rot_t, rot_j), (trans_t, trans_j)]
    pts = rng.normal(size=(1, 3, 5, 7)).astype(np.float32) + [[[[0]], [[0]],
                                                              [[3]]]]
    pts = pts.astype(np.float32)
    pairs.append((tgeo.transform_points(_t(pose), _t(pts)),
                  jgeo.transform_points(pose, pts)))
    flat = pts.reshape(1, 3, -1)
    for got, want in zip(tgeo.project_points(_t(k), _t(flat)),
                         jgeo.project_points(k, flat)):
        pairs.append((got, want))
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                                   rtol=1e-6)


@pytest.mark.parametrize("h,w", [(7, 9), (1, 5), (6, 2)])
def test_bilinear_sample_matches_stacked_sampler(h, w):
    """Interior, edge-exact, just-outside and far-outside coordinates."""
    rng = np.random.default_rng(1)
    b, n, c = 2, 257, 4
    src = rng.normal(size=(b, h, w, c)).astype(np.float32)
    x = rng.uniform(-1.5, w + 0.5, size=(b, n)).astype(np.float32)
    y = rng.uniform(-1.5, h + 0.5, size=(b, n)).astype(np.float32)
    edges_x = np.array([0.0, w - 1.0, -1e-6, w - 1 + 1e-5, 0.5, w - 1.5],
                       np.float32)
    edges_y = np.array([h - 1.0, 0.0, 0.25, h - 1.0, -1e-6, h - 1 + 1e-5],
                       np.float32)
    x[:, :6] = edges_x
    y[:, :6] = edges_y
    got = tsampling.bilinear_sample(_t(src), _t(x), _t(y))
    want = jsampling.bilinear_sample_stacked(src, x, y)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def _sweep_inputs(h=16, w=20, c=8, d=ND):
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(1, h, w, c)).astype(np.float32)
    intr = _intr(h, w, 18.0)
    dvals = _dv(d)
    return feat, intr, dvals


@pytest.mark.parametrize("pose", TRANSLATIONS + ROTATIONS)
def test_plane_sweep_plain_matches_xla(pose):
    feat, intr, dvals = _sweep_inputs()
    ref_proj = jgeo.camera_projection(intr, _pose())
    src_proj = jgeo.camera_projection(intr, pose)
    want = jwarp.plane_sweep_warp(feat, src_proj, ref_proj, dvals)
    got = twarp.plane_sweep_warp(_t(feat), _t(src_proj), _t(ref_proj),
                                 _t(dvals))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_plane_sweep_plain_matches_pallas_interpret():
    """The Pallas function's two-pass row-crossing form: exact for pure
    translations (5e-4), sub-pixel deviation under rotation (2e-2)."""
    feat, intr, dvals = _sweep_inputs()
    ref_proj = jgeo.camera_projection(intr, _pose())
    for poses, atol in ((TRANSLATIONS, 5e-4), (ROTATIONS, 2e-2)):
        for pose in poses:
            src_proj = jgeo.camera_projection(intr, pose)
            want = jwarp.plane_sweep_warp(feat, src_proj, ref_proj, dvals,
                                          backend="pallas")
            got = twarp.plane_sweep_warp(_t(feat), _t(src_proj),
                                         _t(ref_proj), _t(dvals))
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       atol=atol, rtol=0.0)


def test_plane_sweep_recovers_the_analytic_depth():
    """Frames 0 and 4 of the synthetic scene (a textured slanted plane at
    ~2.5 m, ~0.33 m of baseline) at 128x160, focal halved, swept at 64
    planes over 0.01-10 m through the plane-sweep kernel's wrapper (on CPU
    tensors its plain version; the kernel equals it bit for bit on the
    card, tests/test_torch_port_cuda.py). A plane shifts each co-visible
    pixel by a pixel or more, so the argmin over planes of the 5x5
    box-filtered |ref - warped| must recover the analytic depth's plane
    index within +-1 on at least 80% of the pixels seen in both views."""
    from estdepth_tpu_torch.data.synthetic import (
        SyntheticSceneConfig, intrinsics, pose, render,
    )
    from estdepth_tpu_torch.ops.cuda import plane_warp

    h, w, d, lo, hi = 128, 160, 64, 0.01, 10.0
    cfg = SyntheticSceneConfig(height=h, width=w, focal=144.4676515)
    rgb0, depth0 = render(cfg, pose(cfg, 0))
    rgb4, _ = render(cfg, pose(cfg, 4))

    def rgbx(rgb):  # pad to 4 channels: the kernel takes C % 4 == 0
        return torch.from_numpy(np.pad(rgb, ((0, 0), (0, 0), (0, 1))))

    k = torch.from_numpy(intrinsics(cfg))[None]
    proj_ref, proj_src = (tgeo.camera_projection(
        k, torch.from_numpy(pose(cfg, f))[None]) for f in (0, 4))
    dv = torch.linspace(lo, hi, d)[None]
    x, y = twarp.plane_sweep_coords(proj_src, proj_ref, dv, h, w)
    warped = plane_warp.plane_sweep_sample(rgbx(rgb4)[None], x, y)
    cost = (warped[0] - rgbx(rgb0)).abs().sum(-1)  # [D, H, W]
    cost = torch.nn.functional.avg_pool2d(cost[None], 5, stride=1,
                                          padding=2)[0]
    est = cost.argmin(0).numpy()
    gt = np.clip(np.rint((depth0 - lo) / ((hi - lo) / (d - 1))), 0, d - 1)
    gt = gt.astype(np.int64)
    xs, ys = (_np(q).reshape(d, h, w) for q in (x, y))
    xg = np.take_along_axis(xs, gt[None], 0)[0]
    yg = np.take_along_axis(ys, gt[None], 0)[0]
    seen = ((xg >= 0) & (xg <= w - 1) & (yg >= 0) & (yg <= h - 1)
            & (depth0 > lo))
    shift = np.abs(np.take_along_axis(xs, np.minimum(gt + 1, d - 1)[None],
                                      0)[0] - xg)
    assert seen.mean() > 0.5 and shift[seen].min() >= 1.0
    assert np.mean(np.abs(est - gt)[seen] <= 1) >= 0.8


def _smooth_volume(rng, b, d, h, w, c):
    coarse = rng.normal(size=(b, max(d // 4, 1), max(h // 4, 1),
                              max(w // 4, 1), c)).astype(np.float32)
    return np.asarray(jax.image.resize(jnp.asarray(coarse), (b, d, h, w, c),
                                       method="trilinear"))


def _rel(tvec=(0.05, 0.02, 0.01), rot=(0.01, -0.02, 0.005)):
    from estdepth_tpu.ops.se3 import exp_map

    return np.asarray(exp_map(jnp.asarray([rot + tvec], jnp.float32)))


def _frustum(vol, rel, intr, mode):
    return np.asarray(jwarp.frustum_warp(vol, rel, intr, _dv(),
                                         DMIN, DINT, mode=mode))


def _port_frustum(vol, rel, intr):
    return _np(twarp.frustum_warp(_t(vol), _t(rel), _t(intr),
                                  _t(_dv()), DMIN, DINT))


def test_zi_field_matches_jax():
    h, w = 12, 16
    intr = _intr(h, w, 60.0)
    t = np.linalg.inv(_rel()).astype(np.float32)
    want = jez.zi_field(t, intr, _dv(), DMIN, DINT, jgeo.pixel_grid(h, w))
    got = tez.zi_field(_t(t), _t(intr), _t(_dv()), DMIN, DINT,
                       tgeo.pixel_grid(h, w))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    # the behind-camera sentinel: a plane seen from behind
    t_back = _pose(tz=-20.0)
    got = _np(tez.zi_field(_t(t_back), _t(intr), _t(_dv()), DMIN, DINT,
                           tgeo.pixel_grid(h, w)))
    want = np.asarray(jez.zi_field(t_back, intr, _dv(), DMIN, DINT,
                                   jgeo.pixel_grid(h, w)))
    np.testing.assert_array_equal(got == -2.0, want == -2.0)
    assert (got == -2.0).any()


@pytest.mark.parametrize("case", ["realistic", "translation", "far"])
def test_exact_z_plain_matches_xla(case):
    rng = np.random.default_rng(2)
    b, h, w, c = 1, 24, 32, 8
    vol = _smooth_volume(rng, b, ND, h, w, c)
    rel = {"realistic": _rel(), "translation": _pose(tx=0.07, tz=0.05),
           "far": _pose(tx=1e3)}[case]
    intr = _intr(h, w, 60.0)
    want = _frustum(vol, rel, intr, "plane_mix_exact_z")
    got = _port_frustum(vol, rel, intr)
    scale = np.abs(vol).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0.0)


def test_exact_z_plain_close_to_pallas_f32():
    """tests/test_exact_z_warp.py:117-131: the Pallas two-pass x deviation
    is the only difference."""
    rng = np.random.default_rng(2)
    b, h, w, c = 1, 24, 32, 8
    vol = _smooth_volume(rng, b, ND, h, w, c)
    rel, intr = _rel(), _intr(h, w, 60.0)
    pls = _frustum(vol, rel, intr, "plane_mix_pallas_exact_z")
    got = _port_frustum(vol, rel, intr)
    scale = np.abs(got).max()
    m = (np.abs(got) > 0) & (np.abs(pls) > 0)
    assert np.median(np.abs(pls - got)[m]) < 2e-3 * scale
    corr = np.corrcoef(got[m].ravel(), pls[m].ravel())[0, 1]
    assert corr > 0.999, corr


def test_exact_z_plain_close_to_pallas_packed():
    """tests/test_exact_z_warp.py:150-168: bf16 transport of (A', s)."""
    rng = np.random.default_rng(5)
    b, h, w, c = 1, 24, 32, 8
    vol = _smooth_volume(rng, b, ND, h, w, c)
    rel, intr = _rel(), _intr(h, w, 60.0)
    pk = _frustum(vol, rel, intr, "plane_mix_pallas_exact_z_packed")
    got = _port_frustum(vol, rel, intr)
    scale = np.abs(got).max()
    diff = np.abs(pk - got)
    assert diff.max() < 2e-2 * scale, diff.max()
    assert diff.mean() < 1e-3 * scale, diff.mean()


def test_unknown_frustum_mode_and_padding_raise():
    vol = torch.zeros(1, 2, 4, 4, 4)
    args = (vol, torch.eye(4)[None], _t(_intr(4, 4, 5.0)), _t(_dv(2)), DMIN,
            DINT)
    with pytest.raises(ValueError, match="unknown frustum_warp mode"):
        twarp.frustum_warp(*args, mode="plane_mix_pallas")
    with pytest.raises(ValueError, match="unknown padding_mode"):
        twarp.frustum_warp(*args, padding_mode="reflect", mode="exact")
    for mode in ("plane_mix", "plane_mix_exact_z"):
        with pytest.raises(ValueError, match="zeros padding only"):
            twarp.frustum_warp(*args, padding_mode="border", mode=mode)


@pytest.mark.parametrize("d,h,w", [(5, 7, 9), (1, 4, 5), (6, 1, 2)])
def test_trilinear_sample_matches_stacked_sampler(d, h, w):
    """Interior, edge-exact, just-outside and far-outside coordinates."""
    rng = np.random.default_rng(11)
    b, n, c = 2, 301, 4
    src = rng.normal(size=(b, d, h, w, c)).astype(np.float32)
    x = rng.uniform(-1.5, w + 0.5, size=(b, n)).astype(np.float32)
    y = rng.uniform(-1.5, h + 0.5, size=(b, n)).astype(np.float32)
    z = rng.uniform(-1.5, d + 0.5, size=(b, n)).astype(np.float32)
    x[:, :6] = [0.0, w - 1.0, -1e-6, w - 1 + 1e-5, 0.5, w - 1.5]
    y[:, :6] = [h - 1.0, 0.0, 0.25, h - 1.0, -1e-6, h - 1 + 1e-5]
    z[:, :6] = [0.0, d - 1.0, 0.5, d - 1.0, 0.0, 0.25]
    z[:, 6:9] = [-1e-6, d - 1 + 1e-5, d - 1.0]
    x[:, 6:9] = y[:, 6:9] = 0.0
    got = tsampling.trilinear_sample(_t(src), _t(x), _t(y), _t(z))
    want = jsampling.trilinear_sample_stacked(src, x, y, z)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def _random_volume(seed=7, b=1, d=ND, h=16, w=20, c=8):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, d, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("padding_mode,padding_value",
                         [("zeros", 0.0), ("border", 0.0), ("border", -1.5)])
def test_exact_frustum_warp_matches_jax(padding_mode, padding_value):
    """mode="exact": one trilinear sample per voxel, with zeros padding and
    with the border shell (set_volume_border) under clamped coordinates."""
    vol = _random_volume()
    intr = _intr(16, 20, 18.0)
    for rel in TRANSLATIONS + ROTATIONS + [_pose(tx=1e3)]:
        want = jwarp.frustum_warp(vol, rel, intr, _dv(), DMIN, DINT,
                                  padding_mode=padding_mode,
                                  padding_value=padding_value, mode="exact")
        got = twarp.frustum_warp(_t(vol), _t(rel), _t(intr), _t(_dv()),
                                 DMIN, DINT, padding_mode=padding_mode,
                                 padding_value=padding_value, mode="exact")
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)


def test_set_volume_border_matches_jax():
    vol = _random_volume(b=2, d=3, h=4, w=5, c=2)
    got = twarp.set_volume_border(_t(vol), 0.25)
    want = jwarp.set_volume_border(jnp.asarray(vol), 0.25)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert (vol != 0.25).all()  # the input is left as it was


def _port_plane_mix(vol, rel, intr):
    return _np(twarp.frustum_warp(_t(vol), _t(rel), _t(intr), _t(_dv()),
                                  DMIN, DINT, mode="plane_mix"))


@pytest.mark.parametrize("case", ["realistic", "translation", "rotation",
                                  "far"])
def test_plane_mix_plain_matches_xla(case):
    """The plain version of kernel 4 (2-tap z-mix, then a bilinear sample)
    against the JAX dense hat-weight einsum form."""
    rng = np.random.default_rng(2)
    b, h, w, c = 1, 24, 32, 8
    vol = _smooth_volume(rng, b, ND, h, w, c)
    rel = {"realistic": _rel(), "translation": _pose(tx=0.07, tz=0.05),
           "rotation": ROTATIONS[1], "far": _pose(tx=1e3)}[case]
    intr = _intr(h, w, 60.0)
    want = _frustum(vol, rel, intr, "plane_mix")
    got = _port_plane_mix(vol, rel, intr)
    scale = np.abs(vol).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0.0)
    if case == "far":
        assert np.abs(got).max() == 0.0
    else:
        assert np.abs(got).max() > 0.1 * scale


def test_plane_mix_z_window_fades_at_the_ends():
    """A corner's plane index just outside [0, Z-1] but inside the eps
    window keeps its value, faded by its distance (the hat weight), and is
    zero beyond eps; the -2 sentinel is zero."""
    from estdepth_tpu_torch.ops.cuda.plane_mix import z_mix

    z = 4
    vol = torch.arange(1.0, z + 1).reshape(1, z, 1, 1, 1).expand(1, z, 1, 1, 4)
    zi = torch.tensor([[-2.0, -2e-3, -5e-4, 0.0, 1.25, z - 1.0,
                        z - 1 + 5e-4, z - 1 + 2e-3]]).reshape(1, 8, 1)
    got = z_mix(vol.contiguous(), zi)[0, :, 0, 0].numpy()
    want = [0.0, 0.0, 1.0 - 5e-4, 1.0, 2.25, 4.0, 4.0 * (1 - 5e-4), 0.0]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_plane_mix_plain_close_to_pallas_interpret():
    """tests/test_pallas_warp.py:53-89: the Pallas function's extra
    deviation is its two-pass x evaluation at row crossings (2e-2 over the
    poses, 2e-3 against it for in-plane motion, where it is exact), and a
    warp that throws every sample out of the frustum gives exactly 0."""
    vol = _random_volume()
    intr = _intr(16, 20, 18.0)
    dv5 = np.linspace(0.5, 5.0, ND, dtype=np.float32)[None]
    dint = float(dv5[0, 1] - dv5[0, 0])

    def both(rel):
        pls = np.asarray(jwarp.frustum_warp(vol, rel, intr, dv5, 0.5, dint,
                                            mode="plane_mix_pallas"))
        got = _np(twarp.frustum_warp(_t(vol), _t(rel), _t(intr), _t(dv5),
                                     0.5, dint, mode="plane_mix"))
        return got, pls

    for rel in TRANSLATIONS + ROTATIONS:
        got, pls = both(rel)
        np.testing.assert_allclose(got, pls, atol=2e-2, rtol=0.0)
    for rel in (_pose(), _pose(tx=0.07), _pose(tx=-0.03, ty=0.06)):
        got, pls = both(rel)
        np.testing.assert_allclose(got, pls, atol=2e-3, rtol=1e-3)
    got, pls = both(_pose(tx=1e3))
    assert np.abs(got).max() == 0.0 and np.abs(pls).max() == 0.0
