"""The port's modules, model forward and ESTM stream against the JAX package
on CPU (the PARITY.md harness rows, with the JAX model as the reference).

The tiny configuration, the numpy-drawn weights and the pitched camera
path of tests/test_torch_port_common.py, with JAX's warps set to the eval
tools' non-TPU default (fast_frustum + exact_z: frustum_warp mode
"plane_mix_exact_z").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.eval.estm import ESTMRunner as JaxRunner
from estdepth_tpu.models import ESTMemory as JaxMemory
from estdepth_tpu.models.est_transformer import EpipolarTransformer as JaxEST
from estdepth_tpu.models.psm import PSMFeatureNet as JaxPSM
from estdepth_tpu.models.resnet import ResNetEncoder as JaxResNet
from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.eval.output import trim_depth
from estdepth_tpu_torch.models.est_transformer import EpipolarTransformer
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.models.memory import ESTMemory
from estdepth_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_common import (
    DMAX, DMIN, ND, H, W, model_pair, pitched_frames, random_variables,
)
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _window(frames, start):
    sl = frames[start:start + 3]
    return (np.stack([f["img"] for f in sl])[None],
            np.stack([f["cam_pose"] for f in sl])[None],
            frames[0]["cam_intr"][None])


@pytest.fixture(scope="module")
def models():
    jm, variables, tm = model_pair()
    frames = pitched_frames()
    return jm, variables, tm, frames


def _sub(variables, name):
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"][name]}


def test_psm_features_match_jax(models):
    jm, variables, tm, frames = models
    imgs = np.stack([f["img"] for f in frames[:2]])
    x = (2.0 * (imgs / 255.0) - 1.0).astype(np.float32)
    want = np.asarray(JaxPSM().apply(_sub(variables, "matching_feature"),
                                     jnp.asarray(x)))
    with torch.inference_mode():
        got = tm.compute_matching(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_resnet18_features_match_jax(models):
    jm, variables, tm, frames = models
    _check_resnet(tm.semanticFeature, 18, _sub(variables, "semantic_feature"),
                  frames)


def test_resnet50_features_match_jax(models):
    """The flagship encoder: Bottleneck blocks with projection shortcuts."""
    _, _, _, frames = models
    x = np.zeros((1, H, W, 3), np.float32)
    variables = random_variables(lambda: JaxResNet(50).init(
        jax.random.key(0), jnp.asarray(x)), seed=5)
    tm = DepthNetHybrid(ModelConfig(ndepths=ND, resnet=50))
    prefix = "semanticFeature."
    sd = state_dict_from_jax({"params": {"semantic_feature":
                                         variables["params"]},
                              "batch_stats": {"semantic_feature":
                                              variables["batch_stats"]}})
    tm.semanticFeature.load_state_dict(
        {k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    _check_resnet(tm.semanticFeature, 50, variables, frames)


def _check_resnet(encoder, depth, variables, frames):
    imgs = np.stack([f["img"] for f in frames[:2]])
    x = (2.0 * (imgs / 255.0) - 1.0).astype(np.float32)
    want = JaxResNet(depth).apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-3, atol=2e-4)


def test_est_transformer_matches_jax():
    """Attention with a masked (invalid) neighbour, and the zero-h
    fallback."""
    rng = np.random.default_rng(3)
    b, d, h, w, c, n = 1, 4, 5, 6, 8, 3
    tk, tv = (rng.normal(size=(b, d, h, w, c)).astype(np.float32)
              for _ in range(2))
    wk, wv = (rng.normal(size=(n, b, d, h, w, c)).astype(np.float32)
              for _ in range(2))
    valid = np.array([[True], [False], [True]])
    jmod = JaxEST(c)
    variables = random_variables(lambda: jmod.init(
        jax.random.key(0), jnp.asarray(tk), jnp.asarray(tv),
        jnp.asarray(wk), jnp.asarray(wv), jnp.asarray(valid)), seed=4)
    tmod = EpipolarTransformer(c)
    prefix = "CostRegNet.epipolar_transformer."
    sd = state_dict_from_jax({"params": {"decoder": {
        "est": variables["params"]}}})
    tmod.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                         strict=True)
    for args in ((wk, wv, valid), ()):
        want = np.asarray(jmod.apply(variables, jnp.asarray(tk),
                                     jnp.asarray(tv),
                                     *map(jnp.asarray, args)))
        with torch.inference_mode():
            got = tmod(torch.from_numpy(tk), torch.from_numpy(tv),
                       *map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _jax_forward(jm, variables, window, memory):
    return jm.apply(variables, *map(jnp.asarray, window), memory=memory,
                    use_est=memory is not None, train=False)


def _port_forward(tm, window, memory):
    with torch.inference_mode():
        return tm(*map(torch.from_numpy, window), memory=memory,
                  use_est=memory is not None)


def _check_outputs(got, want, atol):
    for k in ("depth", "init_prob", "fused_prob"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol, rtol=0.0, err_msg=k)


def test_forward_no_est_and_est_match_jax(models):
    """The first window without EST, then the next window fusing a memory
    that holds the first window's state and one empty slot."""
    jm, variables, tm, frames = models
    w0, w1 = _window(frames, 0), _window(frames, 1)
    want0, (jk, jv, jp) = _jax_forward(jm, variables, w0, None)
    got0, (tk, tv, tp) = _port_forward(tm, w0, None)
    _check_outputs(got0, want0, 5e-3)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=5e-3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=5e-3)

    jmem = JaxMemory.create(1, 2, ND, H // 4, W // 4).push(jk, jv, jp)
    tmem = ESTMemory.create(1, 2, ND, H // 4, W // 4).push(tk, tv, tp)
    want1, _ = _jax_forward(jm, variables, w1, jmem)
    got1, _ = _port_forward(tm, w1, tmem)
    _check_outputs(got1, want1, 5e-3)


@pytest.mark.parametrize("lwindow,memory_size,n_frames",
                         [(3, 2, 7), (5, 3, 8)])
def test_estm_runner_chain_matches_jax(models, lwindow, memory_size,
                                       n_frames):
    """The streaming runner over a chain of windows (carried matching
    features, the first window without EST, a filling memory), all 4
    scales. lwindow 3 is the eval default (5 windows); lwindow 5 has 3
    targets per window, so in-window fusion runs in the reference's
    sequential order (targets j < i already fused)."""
    jm, variables, tm, frames = models
    jr = JaxRunner(jm, variables, H, W, lwindow=lwindow,
                   memory_size=memory_size)
    tr = ESTMRunner(tm, H, W, lwindow=lwindow, memory_size=memory_size,
                    device="cpu")
    emitted = 0
    for f in frames[:n_frames]:
        want = jr.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
        got = tr.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
        assert (want is None) == (got is None)
        if got is not None:
            emitted += 1
            assert got.shape == (1, 4, H, W)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=8e-3, rtol=0.0)
    assert emitted == n_frames - lwindow + 1
    assert bool(tr.memory.valid.all())
    tr.reset()
    assert not bool(tr.memory.valid.any())


def test_estm_runner_options(models):
    """output_scales / return_probs, uint8 frames, and batch > 1 streams
    (each stream equals the single-stream result); output_dtype casts."""
    _, _, tm, frames = models
    one = ESTMRunner(tm, H, W, device="cpu")
    two = ESTMRunner(tm, H, W, batch=2, output_scales=(0, 2),
                     return_probs=True, device="cpu")
    for f in frames[:4]:
        img = f["img"].astype(np.uint8)
        a = one.push_frame(img, f["cam_pose"], f["cam_intr"])
        b = two.push_frame(np.stack([img, img]), f["cam_pose"],
                           f["cam_intr"])
    depth, probs = b
    assert depth.shape == (2, 2, H, W) and probs.shape == (2, 2, H, W)
    for s in range(2):
        np.testing.assert_allclose(depth[s].numpy(), a[0, [0, 2]].numpy(),
                                   atol=1e-5)
    half = trim_depth(a, (0,), torch.bfloat16)
    assert half.shape == (1, 1, H, W) and half.dtype == torch.bfloat16
