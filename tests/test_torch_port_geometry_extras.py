"""The port's se3 and image-warp helpers against the JAX package's on CPU
(mirroring tests/test_geometry_extras.py): the same numpy inputs through
estdepth_tpu.ops.{se3,image_warp} and estdepth_tpu_torch.ops.{se3,
image_warp}. The se3 functions at atol 1e-5, the warps at the PARITY.md
warp row, atol 1e-4.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.ops import image_warp as jimage_warp
from estdepth_tpu.ops import se3 as jse3
from estdepth_tpu_torch.ops import image_warp, se3
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SE3_ATOL, WARP_ATOL = 1e-5, 1e-4


def _twists(n=6, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).normal(size=(n, 6))).astype(
        np.float32)


def test_skew_matches_jax_and_is_the_cross_product():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(4, 3)).astype(np.float32)
    got = se3.skew(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jse3.skew(jnp.asarray(a))),
                               atol=SE3_ATOL, rtol=0)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", got, b),
                               np.cross(a, b), atol=1e-6)


@pytest.mark.parametrize("scale", [0.3, 1e-9], ids=["twist", "near_zero"])
def test_exp_map_matches_jax(scale):
    """A batch of twists, and twists at the small-angle guard."""
    ksai = _twists(scale=scale)
    got = se3.exp_map(torch.from_numpy(ksai)).numpy()
    want = np.asarray(jse3.exp_map(jnp.asarray(ksai)))
    np.testing.assert_allclose(got, want, atol=SE3_ATOL, rtol=0)
    rot = got[:, :3, :3]
    np.testing.assert_allclose(np.einsum("bij,bkj->bik", rot, rot),
                               np.tile(np.eye(3), (len(ksai), 1, 1)),
                               atol=1e-5)


def test_log_map_matches_jax_and_inverts_exp_map():
    ksai = _twists(seed=2)
    mats = np.array(jse3.exp_map(jnp.asarray(ksai)))
    got = se3.log_map(torch.from_numpy(mats)).numpy()
    np.testing.assert_allclose(got, np.asarray(jse3.log_map(
        jnp.asarray(mats))), atol=SE3_ATOL, rtol=0)
    np.testing.assert_allclose(got, ksai, atol=1e-4)


def test_numpy_rotation_helpers_match_jax():
    """mat2euler_np and quat2mat_np are copies: equal on a 90-degree yaw
    and on random unit quaternions."""
    rng = np.random.default_rng(3)
    quats = [(np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0), (0, 0, 0, 0)]
    quats += [tuple(q / np.linalg.norm(q)) for q in rng.normal(size=(4, 4))]
    for q in quats:
        rot = se3.quat2mat_np(q)
        np.testing.assert_array_equal(rot, jse3.quat2mat_np(q))
        np.testing.assert_array_equal(se3.mat2euler_np(rot),
                                      jse3.mat2euler_np(rot))
    rot = se3.quat2mat_np(quats[0])
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(se3.mat2euler_np(rot)[1], np.pi / 2,
                               atol=1e-6)


def _camera(h, w, f=20.0):
    return np.array([[[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]]],
                    np.float32)


def test_inverse_warp_identity():
    """The identity pose gives the source back inside the border."""
    b, h, w, c = 1, 10, 12, 3
    feat = np.random.default_rng(4).normal(size=(b, h, w, c)).astype(
        np.float32)
    depth = np.full((b, h, w), 2.0, np.float32)
    pose = np.eye(4, dtype=np.float32)[None]
    out = image_warp.inverse_warp(*map(torch.from_numpy, (
        feat, depth, pose, _camera(h, w)))).numpy()
    np.testing.assert_allclose(out[:, 1:-1, 1:-1], feat[:, 1:-1, 1:-1],
                               atol=WARP_ATOL)


def test_inverse_warp_matches_jax():
    """Two batch entries, random depth and a small random motion each."""
    rng = np.random.default_rng(5)
    b, h, w, c = 2, 16, 20, 5
    feat = rng.normal(size=(b, h, w, c)).astype(np.float32)
    depth = rng.uniform(1.5, 4.0, (b, h, w)).astype(np.float32)
    pose = np.array(jse3.exp_map(jnp.asarray(_twists(b, seed=6,
                                                       scale=0.05))))
    k = np.repeat(_camera(h, w), b, 0)
    args = (feat, depth, pose, k)
    got = image_warp.inverse_warp(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(jimage_warp.inverse_warp(*map(jnp.asarray, args)))
    assert got.shape == want.shape == (b, h, w, c)
    np.testing.assert_allclose(got, want, atol=WARP_ATOL, rtol=0)


def test_warp_depth_translation():
    """A z-translation of -0.5 adds 0.5 to every depth (homo_utils.py:296
    applies inverse(rel_pose))."""
    b, h, w = 1, 8, 10
    depth = np.full((b, h, w), 3.0, np.float32)
    rel = np.eye(4, dtype=np.float32)[None].copy()
    rel[:, 2, 3] = -0.5
    z, valid = image_warp.warp_depth(*map(torch.from_numpy, (
        depth, rel, _camera(h, w))))
    np.testing.assert_allclose(z.numpy(), 3.5, atol=1e-5)
    assert bool(valid.all())


def test_warp_depth_matches_jax():
    """Random depth and motion: the warped depth at 1e-4 and the same
    validity mask."""
    rng = np.random.default_rng(7)
    b, h, w = 2, 12, 16
    depth = rng.uniform(1.0, 5.0, (b, h, w)).astype(np.float32)
    rel = np.array(jse3.exp_map(jnp.asarray(_twists(b, seed=8,
                                                      scale=0.2))))
    k = np.repeat(_camera(h, w), b, 0)
    z, valid = image_warp.warp_depth(*map(torch.from_numpy, (depth, rel, k)))
    jz, jvalid = jimage_warp.warp_depth(*map(jnp.asarray, (depth, rel, k)))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=WARP_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < valid.float().mean() < 1
