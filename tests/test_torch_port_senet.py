"""The SE encoder family and the SENet model on the port against the JAX
package on CPU.

Weights are drawn with numpy from a seed for the JAX tree and carried over
by the weight bridge (`state_dict_from_jax` for the model and the feature
net, `senet_state_dict_from_jax` for the classifier), loaded strictly.
Tolerances are the PARITY.md rows: the encoder row (rtol 1e-3, atol 2e-4)
for the SE modules, blocks, SEFeatureNet and the SENet classifiers; the
full forward 5e-3; the 5-window ESTM chain and the Joint processor 8e-3;
bf16 within twice JAX bf16's own distance from JAX float32; one training
step against JAX's make_train_step at tests/test_torch_port_train_jax.py's
tolerances (loss, gradient norm, BatchNorm statistics, gradients tensor
by tensor). senet154
is held by its parameter shapes only (its forward is what makes
tests/test_senet.py slow).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import estdepth_tpu.models.senet as jsenet
from estdepth_tpu.eval import sequence as jsequence
from estdepth_tpu.eval.estm import ESTMRunner as JaxRunner
from estdepth_tpu.models import DepthNetHybrid as JaxModel
from estdepth_tpu.parallel.mesh import create_mesh, shard_batch
from estdepth_tpu.train.schedule import warmup_multistep_schedule as jax_sched
from estdepth_tpu.train.trainer import (
    TrainState as JaxTrainState, make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.eval import sequence as tsequence
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.models import senet as tsenet
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.train.schedule import warmup_multistep_schedule
from estdepth_tpu_torch.train.trainer import make_optimizer, make_train_step
from estdepth_tpu_torch.utils.convert import (
    grads_from_jax, senet_state_dict_from_jax, state_dict_from_jax,
)
from test_torch_port_common import (  # noqa: F401
    DMAX, DMIN, H, JAX_WARP_FLAGS, ND, W, model_pair, one_torch_thread,
    pitched_frames, random_variables, scene_arrays, training_test_env,
)

pytestmark = pytest.mark.usefixtures("training_test_env")

ENC = dict(rtol=1e-3, atol=2e-4)  # the encoder row of PARITY.md
SENET = dict(feature_net="senet")


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _jax_pair(jax_module, x: np.ndarray, **apply_kw):
    """(numpy variables of jax_module's tree, its output on x)."""
    variables = random_variables(lambda: jax_module.init(
        jax.random.key(0), jnp.asarray(x), **apply_kw))
    out = jax.jit(lambda v, a: jax_module.apply(v, a, **apply_kw))(
        variables, jnp.asarray(x))
    return variables, out


def _load_sub(module, variables, prefix="matchingFeature."):
    """The port's module loaded strictly with JAX variables of a matching
    encoder's subtree (SEFeatureNet's, or {"layer1_0": a block's}), mapped
    by state_dict_from_jax and taken from under `prefix`."""
    sd = state_dict_from_jax({
        "params": {"matching_feature": variables["params"]},
        "batch_stats": {"matching_feature": variables["batch_stats"]}})
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                           strict=True)
    return module.eval()


# ------------------------------------------------------------- SE modules

def test_se_module_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
    variables = random_variables(lambda: jsenet.SEModule(64, 4).init(
        jax.random.key(0), jnp.asarray(x)))
    want = jsenet.SEModule(64, 4).apply(variables, jnp.asarray(x))
    tm = tsenet.SEModule(64, 4)
    tm.load_state_dict({
        f"{fc}.{leaf}": torch.from_numpy(np.asarray(
            np.transpose(v["kernel"], (3, 2, 0, 1)) if leaf == "weight"
            else v["bias"]))
        for fc, v in variables["params"].items()
        for leaf in ("weight", "bias")})
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), **ENC)


# (JAX block, port block, JAX kwargs, input channels, stride)
BLOCKS = {
    "se_stride2_ds3": (jsenet.SEBottleneck, tsenet.SEBottleneck,
                       dict(downsample=True, downsample_kernel=3), 64, 2),
    "se_wide_conv2": (jsenet.SEBottleneck, tsenet.SEBottleneck,
                      dict(wide_conv2=True, groups=8), 128, 1),
    "se_resnet_stride2_ds1": (jsenet.SEResNetBottleneck,
                              tsenet.SEResNetBottleneck,
                              dict(downsample=True), 64, 2),
    "se_resnet_stride1": (jsenet.SEResNetBottleneck,
                          tsenet.SEResNetBottleneck, dict(), 128, 1),
    "se_resnext_stride2_ds1": (jsenet.SEResNeXtBottleneck,
                               tsenet.SEResNeXtBottleneck,
                               dict(downsample=True), 64, 2),
    "se_resnext_ds3_groups8": (jsenet.SEResNeXtBottleneck,
                               tsenet.SEResNeXtBottleneck,
                               dict(downsample=True, downsample_kernel=3,
                                    groups=8), 64, 1),
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_se_bottleneck_matches_jax(case):
    """Each bottleneck at stride 1 and 2, downsample kernels 1 and 3 and
    grouped convolutions, at 32 planes (128 channels out)."""
    jcls, tcls, kw, cin, stride = BLOCKS[case]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, 16, cin)).astype(np.float32)
    jm = jcls(32, stride=stride, **kw)
    variables, want = _jax_pair(jm, x, train=False)
    tm = _load_sub(tcls(cin, 32, stride=stride, **kw),
                   {k: {"layer1_0": v} for k, v in variables.items()},
                   "matchingFeature.layer1.0.")
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape == (2, 12 // stride, 16 // stride, 128)
    np.testing.assert_allclose(got, np.asarray(want), **ENC)


def test_se_feature_net_matches_jax():
    """SEFeatureNet at 64x96: the (1/2-scale 128-channel, 1/4-scale
    32-channel) pair."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    variables, (half, quarter) = _jax_pair(jsenet.SEFeatureNet(), x,
                                           train=False)
    tm = _load_sub(tsenet.SEFeatureNet(), variables)
    assert tm.lastconv[-1].out_channels == 32
    with torch.no_grad():
        got_half, got_quarter = tm(_nchw(x))
    assert got_half.shape == (2, 128, H // 2, W // 2)
    assert got_quarter.shape == (2, 32, H // 4, W // 4)
    np.testing.assert_allclose(_nhwc(got_half), np.asarray(half), **ENC)
    np.testing.assert_allclose(_nhwc(got_quarter), np.asarray(quarter), **ENC)


# ------------------------------------------------------- SENet classifier

@pytest.mark.parametrize("ctor", ["se_resnet50", "se_resnext50_32x4d"])
def test_senet_classifier_matches_jax(ctor):
    """A constructor at 112x112: the layer4 map (features_only) and the
    classifier head (7x7 VALID pool of the 7x7 map, last_linear)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (1, 112, 112, 3)).astype(np.float32)
    jm = getattr(jsenet, ctor)(num_classes=10, pretrained=None)
    variables = random_variables(lambda: jm.init(
        jax.random.key(0), jnp.asarray(x), train=False))
    feats, logits = jax.jit(lambda v, a: (
        jm.apply(v, a, train=False, features_only=True),
        jm.apply(v, a, train=False)))(variables, jnp.asarray(x))
    tm = getattr(tsenet, ctor)(num_classes=10, pretrained=None)
    tm.load_state_dict(senet_state_dict_from_jax(variables), strict=True)
    tm.eval()
    with torch.no_grad():
        got_feats = _nhwc(tm(_nchw(x), features_only=True))
        got_logits = tm(_nchw(x)).numpy()
    assert got_feats.shape == feats.shape == (1, 7, 7, 2048)
    assert got_logits.shape == logits.shape == (1, 10)
    np.testing.assert_allclose(got_feats, np.asarray(feats), **ENC)
    np.testing.assert_allclose(got_logits, np.asarray(logits), **ENC)


def _shapes(state: dict) -> dict:
    return {k: tuple(v.shape) for k, v in state.items()
            if not k.endswith("num_batches_tracked")}


def test_senet154_parameter_shapes_match_jax():
    """senet154 (3x3 stem, wide conv2, groups 64, 3x3 downsample): the
    port's parameter tree equals JAX's under the bridge's names, no
    forward."""
    jm = jsenet.senet154(num_classes=10)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 112, 112, 3)), train=False))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    want = _shapes(senet_state_dict_from_jax(zeros))
    got = _shapes(tsenet.senet154(num_classes=10).state_dict())
    assert len(got) == 982
    assert got == want


def test_constructors_refuse_pretrained_weights():
    with pytest.raises(ValueError, match="converter"):
        tsenet.se_resnet50(pretrained="imagenet")


# ------------------------------------------------------- the SENet model

@pytest.fixture(scope="module")
def pair():
    """(JAX SENet model, variables, the port's, loaded strictly)."""
    return model_pair(views=3, jax_kwargs=SENET, **SENET)


def test_feature_net_choice():
    """An unknown encoder raises JAX's error; the SENet model's matching
    features come from SEFeatureNet's 1/4-scale map."""
    with pytest.raises(ValueError) as port_err:
        DepthNetHybrid(ModelConfig(ndepths=ND, resnet=18, feature_net="vgg"))
    imgs, poses, intr = scene_arrays(3)
    with pytest.raises(ValueError) as jax_err:
        jax.eval_shape(lambda: JaxModel(ndepths=ND, resnet=18,
                                        feature_net="vgg").init(
            jax.random.key(0), imgs[None], poses[None], intr[None]))
    assert str(port_err.value) == str(jax_err.value)
    tm = DepthNetHybrid(ModelConfig(ndepths=ND, resnet=18, **SENET))
    assert isinstance(tm.matchingFeature, tsenet.SEFeatureNet)
    assert tm.compute_matching(torch.zeros(2, H, W, 3)).shape == (
        2, H // 4, W // 4, 32)


def test_senet_model_loads_jax_weights_strictly(pair):
    _, variables, tm = pair
    sd = state_dict_from_jax(variables)
    se_names = {k for k in tm.state_dict() if ".se_module." in k}
    assert len(se_names) == 4 * 12 and se_names <= set(sd)
    missing, unexpected = tm.load_state_dict(sd, strict=True)
    assert not missing and not unexpected


def _window(frames, start, n=3):
    sl = frames[start:start + n]
    return (np.stack([f["img"] for f in sl])[None],
            np.stack([f["cam_pose"] for f in sl])[None],
            frames[0]["cam_intr"][None])


def _jax_depth(jm, variables, window):
    """The JAX model's outputs on one window, EST off (jitted: one compile
    is cheaper than the op-by-op dispatch of the SENet model)."""
    return jax.jit(lambda v, *a: jm.apply(v, *a, train=False)[0])(
        variables, *map(jnp.asarray, window))


@pytest.fixture(scope="module")
def window_f32(pair):
    """The first window of the pitched stream and JAX float32's outputs."""
    jm, variables, _ = pair
    window = _window(pitched_frames(3), 0)
    return window, _jax_depth(jm, variables, window)


def test_senet_forward_matches_jax(pair, window_f32):
    """One window without EST: depth at 4 scales and both probability
    maps at the full-forward tolerance 5e-3."""
    _, _, tm = pair
    window, want = window_f32
    with torch.inference_mode():
        got, _ = tm(*map(torch.from_numpy, window))
    for k in ("depth", "init_prob", "fused_prob"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=5e-3, rtol=0.0, err_msg=k)


def test_senet_estm_chain_matches_jax(pair):
    """5 windows of the stream (lwindow 3, memory 2), all 4 scales."""
    jm, variables, tm = pair
    jr = JaxRunner(jm, variables, H, W)
    tr = ESTMRunner(tm, H, W, device="cpu")
    emitted = 0
    for f in pitched_frames(7):
        want = jr.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
        got = tr.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
        assert (want is None) == (got is None)
        if got is not None:
            emitted += 1
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=8e-3, rtol=0.0)
    assert emitted == 5


def test_senet_joint_processor_matches_jax(pair):
    """The Joint chain over 8 frames (two windows, the second fusing the
    first's state), all 4 scales."""
    jm, variables, tm = pair
    imgs, poses, intr = scene_arrays(8)
    want = jsequence.make_joint_processor(jm, seq_length=5)(
        variables, jnp.asarray(imgs[None]), jnp.asarray(poses[None]),
        jnp.asarray(intr[None]))
    got = tsequence.make_joint_processor(tm, seq_length=5, device="cpu")(
        imgs[None], poses[None], intr[None])
    assert got.shape == want.shape == (1, 2, 3, 4, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=8e-3,
                               rtol=0.0)


def test_senet_bf16_matches_jax(pair, window_f32):
    """The bf16 SENet model on one window: within twice JAX bf16's
    distance from JAX float32, all 4 scales."""
    _, variables, _ = pair
    window, want = window_f32
    jm16 = JaxModel(ndepths=ND, depth_min=DMIN, depth_max=DMAX, resnet=18,
                    est_transformer=True, dtype=jnp.bfloat16, **SENET,
                    **JAX_WARP_FLAGS["plane_mix_exact_z"])
    want16 = np.asarray(_jax_depth(jm16, variables, window)["depth"],
                        np.float32)
    tm16 = DepthNetHybrid(ModelConfig(
        ndepths=ND, depth_min=DMIN, depth_max=DMAX, resnet=18,
        compute_dtype="bfloat16", **SENET))
    tm16.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        got = tm16(*map(torch.from_numpy, window))[0]["depth"]
    own = np.abs(want16 - np.asarray(want["depth"])).max()
    assert 0 < own
    assert np.abs(got.float().numpy() - want16).max() <= 2 * own


def test_senet_train_step_matches_jax():
    """One training step of the SENet model on a 4-frame window (2
    targets: the EST fusion runs), the reference's recipe on both sides,
    against JAX's shipped make_train_step on a 1-device mesh with the
    sync-BN axis: the loss at rtol 3e-3, the gradient norm at 1e-2 and
    every BatchNorm running mean and variance after the step at rtol 5e-3
    (atol 5e-4), as tests/test_torch_port_train_jax.py holds the PSM
    step; and the parameter gradients tensor by tensor under the port's
    names (`grads_from_jax`, the SE blocks' included; JAX's read back
    from Adam's first moment) within 1e-1 per tensor, 3e-2 in the median
    and 2e-2 over all parameters together. And every parameter of the
    port's model gets a gradient, as `trains_every_parameter` says (DDP's
    find_unused_parameters rests on it).

    The gradient tolerances are wider than the PSM step's (2e-2 per
    tensor, 1e-2 overall) because the tiny SENet model's float32 gradient
    is worse conditioned, and by how much is measured by
    scripts/senet_grad_conditioning.py against the port's own float64
    gradient: JAX's float32 gradient lies 1.2e-1 from it at most (median
    1.9e-2, 1.4e-2 overall; the SE gates' fc1 and the pooled branches'
    convolutions lead), the port's float32 4.7e-2 (median 1.1e-2, 7.2e-3
    overall), and the two float32 gradients 7.0e-2 apart at most (median
    2.0e-2, 1.4e-2 overall). A wrong backward (a dropped SE gate term, a
    BatchNorm in the wrong mode, a gradient through the coordinates)
    moves whole tensors by tens of percent."""
    lr, wd, clip, b1 = 4e-5, 4e-4, 10.0, 0.9
    jm, variables, tm = model_pair(
        views=4, jax_kwargs=dict(sequential_cost_bn=True,
                                 bn_axis_name="data", **SENET),
        sequential_cost_bn=True, **SENET)
    frames = pitched_frames(4)
    batch = {
        "imgs": np.stack([f["img"] for f in frames])[None].astype(
            np.float32),
        "cam_poses": np.stack([f["cam_pose"] for f in frames])[None],
        "cam_intr": frames[0]["cam_intr"][None].astype(np.float32),
        "dmaps": np.stack([f["dmap"] for f in frames[1:3]])[None].astype(
            np.float32),
        "dmasks": np.stack([f["dmask"] for f in frames[1:3]])[None]}

    # ---- JAX: the shipped step on a 1-device mesh -------------------------
    mesh = create_mesh(1)
    tx = jax_make_optimizer(
        jax_sched(lr, steps_per_epoch=10**6, warmup_steps=500),
        weight_decay=wd)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(variables["params"]))
    state, scalars = jax_make_train_step(jm, tx, mesh, DMIN, DMAX)(
        state, shard_batch(batch, mesh), jnp.float32(clip))
    mu = jax.device_get(state.opt_state[1].mu)  # (1 - b1) (g + wd p0)
    want_grads = grads_from_jax(jax.tree.map(
        lambda m, p0: np.asarray(m) / (1.0 - b1) - wd * p0, mu,
        variables["params"]))

    # ---- the port ---------------------------------------------------------
    optimizer, scheduler = make_optimizer(
        tm.named_parameters(),
        warmup_multistep_schedule(lr, steps_per_epoch=10**6,
                                  warmup_steps=500), wd)
    step = make_train_step(tm, optimizer, scheduler, DMIN, DMAX)
    got = step({k: torch.from_numpy(v) for k, v in batch.items()}, clip)
    np.testing.assert_allclose(float(got["loss"]), float(scalars["loss"]),
                               rtol=3e-3)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(scalars["grad_norm"]), rtol=1e-2)

    # ---- BatchNorm running statistics after one momentum-0.1 update ------
    want_sd = state_dict_from_jax({
        "params": jax.device_get(state.params),
        "batch_stats": jax.device_get(state.batch_stats)})
    got_sd, init_sd = tm.state_dict(), state_dict_from_jax(variables)
    moved = 0
    for name, want in want_sd.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                got_sd[name].numpy(), want.numpy(), rtol=5e-3, atol=5e-4,
                err_msg=f"BN running stat {name}")
            moved += int(not np.allclose(want.numpy(),
                                         init_sd[name].numpy(), rtol=1e-3))
    assert moved > 100, moved

    # ---- the parameter gradients under the port's names -------------------
    grads = {k: p.grad for k, p in tm.named_parameters()}
    assert set(want_grads) == set(grads)
    global_norm = float(scalars["grad_norm"]) * min(
        1.0, clip / float(scalars["grad_norm"]))
    checked, err2, all2 = {}, 0.0, 0.0
    for name, want in want_grads.items():
        norm = float(want.norm())
        if norm <= 1e-6 * global_norm:
            continue
        diff = float((grads[name] - want).norm())
        assert diff < 1e-1 * norm, (name, diff / norm, norm)
        err2, all2 = err2 + diff ** 2, all2 + norm ** 2
        checked[name] = diff / norm
    assert np.median(list(checked.values())) < 3e-2
    assert (err2 / all2) ** 0.5 < 2e-2, (err2 / all2) ** 0.5
    assert sum(".se_module." in k for k in checked) == 4 * 12
    assert tm.trains_every_parameter(4)
    assert all(p.grad is not None for p in tm.parameters())
