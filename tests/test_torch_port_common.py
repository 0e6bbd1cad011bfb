"""Helpers shared by the port's model-level tests (no test of its own).

One tiny configuration (ndepths 8, 64x96, ResNet-18, as in
tests/test_estm.py). Weights are drawn with numpy from a seed for the JAX
tree and carried to the port through its weight bridge. BatchNorm
statistics and scales are randomized so no branch is an identity; the
residual branches' BN scales stay small so the untrained stacks keep O(1)
activations.

Camera poses carry a small seeded pitch and lift on top of the synthetic
scene's motion. Without it the scene's rows project exactly onto the image
border, where float noise of either framework decides the hard
out-of-range mask and a full feature value flips.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.data.synthetic import SyntheticSceneConfig, synthetic_stream
from estdepth_tpu.models import DepthNetHybrid as JaxModel
from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.utils.convert import state_dict_from_jax

H, W, ND, DMIN, DMAX = 64, 96, 8, 0.5, 8.0


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op PyTorch thread while a module's tests run, the
    process's count after. The suite runs several worker processes side by
    side; with PyTorch's default of one OpenMP thread per core in each of
    them the cores are oversubscribed and the port's CPU convolutions slow
    down thirty-fold (a file that takes 34 s alone took 1063 s). Import the
    fixture into the module and name it in `pytestmark =
    pytest.mark.usefixtures("one_torch_thread")`."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def training_test_env(one_torch_thread):
    """`one_torch_thread` and grad mode on, for a module that runs backward
    passes: every worker process imports every test file, and
    tests/test_reference_parity.py turns grad mode off for its process at
    import."""
    grad = torch.is_grad_enabled()
    torch.set_grad_enabled(True)
    yield
    torch.set_grad_enabled(grad)


def randomize(path, leaf, rng):
    keys = [getattr(p, "key", "") for p in path]
    name = keys[-1]
    residual_bn = (keys[-3:-1] in (["conv2", "bn"], ["conv3", "bn"])
                   or keys[1] == "pre2")
    shape = leaf.shape
    if name == "scale":
        lo, hi = (0.05, 0.2) if residual_bn else (0.5, 1.5)
        return rng.uniform(lo, hi, shape).astype(np.float32)
    if name in ("bias", "mean"):
        return (0.1 * rng.normal(size=shape)).astype(np.float32)
    if name == "var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    fan_in = int(np.prod(shape[:-1]))
    return (rng.normal(size=shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)


def random_variables(init_fn, seed=0):
    """Variables of init_fn's tree shape, drawn with numpy (no JAX init
    compile: eval_shape only traces)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: randomize(p, x, rng), shapes)


def pitch(a):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(a), np.sin(a)
    m[1:3, 1:3] = [[c, -s], [s, c]]
    return m


def pitched_frames(n=8):
    cfg = SyntheticSceneConfig(height=H, width=W, focal=80.0)
    frames = list(synthetic_stream(cfg, n_frames=n, depth_min=DMIN,
                                   depth_max=DMAX))
    for i, f in enumerate(frames):
        p = f["cam_pose"] @ pitch(0.013 * i + 0.002)
        p[1, 3] += 0.011 * i
        f["cam_pose"] = p.astype(np.float32)
    return frames


def scene_arrays(n=11):
    """The pitched scene as arrays: imgs [n, H, W, 3], poses [n, 4, 4],
    intr [3, 3]."""
    frames = pitched_frames(n)
    return (np.stack([f["img"] for f in frames]).astype(np.float32),
            np.stack([f["cam_pose"] for f in frames]).astype(np.float32),
            frames[0]["cam_intr"].astype(np.float32))


# the JAX model's warp switches for each of the port's frustum modes
JAX_WARP_FLAGS = {
    "plane_mix_exact_z": dict(fast_frustum=True, exact_z_warp=True),
    "plane_mix": dict(fast_frustum=True),
    "exact": dict(),
}


def model_pair(views=3, frustum_mode="plane_mix_exact_z", seed=0,
               jax_kwargs=None, **port_kwargs):
    """(JAX model, its variables, the port's model with the same weights,
    loaded strictly), both at the tiny configuration."""
    jm = JaxModel(ndepths=ND, depth_min=DMIN, depth_max=DMAX, resnet=18,
                  est_transformer=True, **JAX_WARP_FLAGS[frustum_mode],
                  **(jax_kwargs or {}))
    imgs, poses, intr = scene_arrays(views)
    variables = random_variables(lambda: jm.init(
        jax.random.key(0), jnp.asarray(imgs[None]), jnp.asarray(poses[None]),
        jnp.asarray(intr[None]), train=False), seed=seed)
    tm = DepthNetHybrid(ModelConfig(
        ndepths=ND, depth_min=DMIN, depth_max=DMAX, resnet=18,
        frustum_mode=frustum_mode, **port_kwargs))
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, variables, tm


def bf16_models(views=5):
    """(JAX bf16 model, JAX float32 model, their variables, the port's bf16
    model with the same weights), both packages at the tiny configuration:
    ModelConfig(compute_dtype="bfloat16") against
    DepthNetHybrid(dtype=jnp.bfloat16)."""
    jm, variables, tm = model_pair(views=views,
                                   jax_kwargs=dict(dtype=jnp.bfloat16),
                                   compute_dtype="bfloat16")
    jm32 = JaxModel(ndepths=ND, depth_min=DMIN, depth_max=DMAX, resnet=18,
                    est_transformer=True,
                    **JAX_WARP_FLAGS["plane_mix_exact_z"])
    return jm, jm32, variables, tm
