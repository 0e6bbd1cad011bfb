"""The width-sharded forward of the port (parallel/spatial.py and the
shard-aware layers, warps and kernels' output windows) on gloo ranks on the
CPU, against the port's unsharded forward and the JAX package.

The ranks run in tests/torch_port_spatial_worker.py: one module-scoped
launch of 2 ranks (96 px as 32 + 64 columns: uneven shards) and one of 3
(32 columns each: a single column at 1/32 scale, as wide as its halo),
started before the JAX programs compile so the three overlap. The tiny
configuration of tests/test_torch_port_common.py (64x96, 8 planes,
ResNet-18), its weights from `model_pair`, so both packages compute the
same function. Held:
  * each shard-aware primitive (halo convolutions 2-D and 3-D at stride 1
    and 2, dilation 2, grouped (SENet's conv2) and the 7x7 stride-2 stem,
    the -inf max-pool,
    GroupNorm, the SE gate, the PSM pyramid) gathered over the ranks
    against its unsharded call at atol 1e-6; shard_width / gather_width
    round trips exact;
  * the sharded two-pass plane sweep (kernel 3's plain version at each
    rank's output window, the line coefficients of its global columns)
    against the JAX package's backend="pallas" under
    ESTDEPTH_FUSED_WARP=1 (the Pallas interpreter) at
    tests/test_torch_port_two_pass.py's 1e-4 x scale;
  * the sharded forward without and with a 2-entry memory (seeded as
    tests/test_spatial_shard.py seeds one; with memory in each of the
    three frustum modes and with the two-pass sweep; the SENet model
    without and with memory) against the port's unsharded forward (depth
    1e-4 m, probabilities 1e-5; measured up to 5.1e-5 and 7.9e-6: a CPU
    convolution may sum a narrower input in another order), its
    collectives counted, and the PSM and SENet models against JAX's
    unsharded model.apply at PARITY.md's full-forward row (5e-3;
    measured 9.5e-6), which JAX's own slow test holds its sharded
    function to, and the SENet model with memory at the chain row (8e-3,
    tests/test_torch_port_senet.py's);
  * a 3-window ESTM chain, the memory pushed from the sharded state,
    against the same chain in JAX at the chain row (8e-3; measured
    1.4e-5);
  * one bf16 forward: sharded within twice bf16's own distance from
    float32 of the unsharded bf16 forward (PR 8's rule; measured 0.68 of
    that distance);
  * the layout's limit (ranks <= W / 32), and the eval-only refusal.
The `slow` test holds the port's sharded forward against the JAX
package's own make_spatial_window_fn on 2 of the conftest's CPU devices.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.models import ESTMemory as JaxMemory
from estdepth_tpu.ops import geometry as jgeo
from estdepth_tpu.ops import warp as jwarp
from estdepth_tpu.parallel.mesh import create_mesh as jax_create_mesh
from estdepth_tpu.parallel.spatial import (
    make_spatial_window_fn as jax_spatial_window_fn,
)
from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.models.memory import ESTMemory
from estdepth_tpu_torch.models.psm import pyramid
from estdepth_tpu_torch.parallel import spatial
from estdepth_tpu_torch.parallel.mesh import Mesh
from test_torch_port_common import (  # noqa: F401
    DMAX, DMIN, H, ND, W, model_pair, one_torch_thread, scene_arrays,
)
from test_torch_port_parallel import _env, _finish, _free_port, _start
from test_torch_port_two_pass import _pose
from torch_port_spatial_worker import FORWARD_CASES, PRIMITIVES, ROUND_TRIPS

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 3)
FRAMES = 5  # the chain's 3 windows of 3 frames
SENET = dict(feature_net="senet")
# the forward cases held against JAX's model.apply, and their tolerances
JAX_CASES = {"forward": 5e-3, "forward_memory": 5e-3, "forward_senet": 5e-3,
             "forward_senet_memory": 8e-3}


def _launch(world: int, inputs: str, out: str, *flags) -> list:
    port = _free_port()
    return _start([[sys.executable, os.path.join(
        REPO, "tests", "torch_port_spatial_worker.py"), "--coordinator",
        f"localhost:{port}", "--rank", str(r), "--world", str(world),
        "--inputs", inputs, "--out", out, *flags] for r in range(world)],
        [_env()] * world)


def _primitive_inputs(rng):
    """Seeded layer states and whole inputs of every PRIMITIVES case, and
    the PSM pyramid's raw and skip maps at 1/4 scale."""
    states, xs = {}, {}
    for name, (make, shape) in PRIMITIVES.items():
        layer = make()
        state = {}
        for k, v in layer.state_dict().items():
            if k == "weight" and v.dim() > 1:
                a = rng.normal(size=v.shape) / np.sqrt(v[0].numel())
            elif k == "weight":
                a = rng.uniform(0.5, 1.5, v.shape)
            else:
                a = 0.1 * rng.normal(size=v.shape)
            state[k] = torch.from_numpy(a.astype(np.float32))
        states[name] = state
        xs[name] = torch.from_numpy(
            (rng.normal(size=shape) + 0.3).astype(np.float32))
    return {"primitive_states": states, "primitive_inputs": xs,
            "pyramid_raw": torch.from_numpy(
                rng.normal(size=(2, 64, H // 4, W // 4)).astype(np.float32)),
            "pyramid_skip": torch.from_numpy(
                rng.normal(size=(2, 128, H // 4, W // 4)).astype(np.float32)),
            **{f"round_trip_{i}": torch.from_numpy(
                rng.normal(size=shape).astype(np.float32))
               for i, (shape, _) in enumerate(ROUND_TRIPS)}}


def _two_pass_sweep_inputs(rng):
    """A plane sweep of a [1, 16, 24, 8] map (1/4 of the image's width)
    over 16 planes under a small rotation, as
    tests/test_torch_port_two_pass.py sweeps one: source lines cross rows
    and some samples leave the image."""
    h, w = 16, W // 4
    intr = np.array([[[18.0, 0, (w - 1) / 2], [0, 18.0, (h - 1) / 2],
                      [0, 0, 1]]], np.float32)
    pose = _pose(tx=0.04, ty=-0.03, tz=0.06, yaw=0.015, pitch=-0.01)
    return {"feat": rng.normal(size=(1, h, w, 8)).astype(np.float32),
            "src_proj": np.array(jgeo.camera_projection(intr, pose)),
            "ref_proj": np.array(jgeo.camera_projection(intr, _pose())),
            "dvals": np.linspace(0.5, 8.0, 16, dtype=np.float32)[None]}


def _memory(poses, rng):
    """A 2-entry memory as tests/test_spatial_shard.py seeds one: normal
    keys, tanh(normal) values, both slots valid at the first frame's
    pose."""
    shape = (1, 2, ND, H // 4, W // 4, 16)
    return {"keys": rng.normal(size=shape).astype(np.float32),
            "values": np.tanh(rng.normal(size=shape)).astype(np.float32),
            "poses": np.tile(poses[:, :1], (1, 2, 1, 1)),
            "valid": np.ones((1, 2), bool)}


def _port_memory(m, dtype=torch.float32):
    return ESTMemory(torch.from_numpy(m["keys"]).to(dtype),
                     torch.from_numpy(m["values"]).to(dtype),
                     torch.from_numpy(m["poses"]), torch.from_numpy(m["valid"]))


def _jax_memory(m):
    return JaxMemory(*(jnp.asarray(m[k])
                       for k in ("keys", "values", "poses", "valid")))


def _port_forward(model, imgs, poses, intr, memory=None):
    with torch.inference_mode():
        out, (key, value, pose) = model(
            torch.from_numpy(imgs), torch.from_numpy(poses),
            torch.from_numpy(intr), memory=memory,
            use_est=memory is not None)
    return {**out, "key": key, "value": value}


def _port_model(tm, **cfg):
    """The port's model of tm's weights with other ModelConfig fields."""
    model = DepthNetHybrid(ModelConfig(ndepths=ND, depth_min=DMIN,
                                       depth_max=DMAX, resnet=18, **cfg))
    model.load_state_dict(tm.state_dict(), strict=True)
    return model


def _np(d):
    """The float32 arrays of a dict of outputs (the counts left out)."""
    return {k: v.float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, np.float32)
            for k, v in d.items() if k != "calls"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's gathered results, and the unsharded port and JAX runs
    of the same inputs."""
    tmp = tmp_path_factory.mktemp("spatial")
    jm, variables, tm = model_pair(views=3)
    jm_se, variables_se, tm_se = model_pair(views=3, jax_kwargs=SENET,
                                            **SENET)
    imgs, poses, intr = scene_arrays(FRAMES)
    imgs, poses, intr = imgs[None], poses[None], intr[None]
    rng = np.random.default_rng(0)
    memory = _memory(poses, rng)
    sweep = _two_pass_sweep_inputs(rng)
    torch.save({"weights": tm.state_dict(),
                "senet_weights": tm_se.state_dict(),
                "imgs": torch.from_numpy(imgs),
                "poses": torch.from_numpy(poses),
                "intr": torch.from_numpy(intr),
                "memory": {k: torch.from_numpy(v) for k, v in memory.items()},
                "two_pass_sweep": {k: torch.from_numpy(v)
                                   for k, v in sweep.items()},
                **_primitive_inputs(rng)}, tmp / "inputs.pt")
    launched = {}
    for world in WORLDS:
        (tmp / str(world)).mkdir()
        launched[world] = _launch(world, str(tmp / "inputs.pt"),
                                  str(tmp / str(world)),
                                  *(["--all"] if world == 2 else []))
    try:
        win = tuple(a[:, :3] for a in (imgs, poses)) + (intr,)
        # ---- JAX, while the ranks run: one program without EST, one with
        apply = jax.jit(lambda v, i, p, k: jm.apply(
            v, i, p, k, use_est=False, train=False))
        apply_mem = jax.jit(lambda v, i, p, k, m: jm.apply(
            v, i, p, k, memory=m, use_est=True, train=False))
        jax_out = {"forward": _np(apply(variables, *win)[0]),
                   "forward_memory": _np(apply_mem(
                       variables, *win, _jax_memory(memory))[0]),
                   "forward_senet": _np(jax.jit(lambda v, i, p, k: jm_se.apply(
                       v, i, p, k, use_est=False, train=False))(
                       variables_se, *win)[0]),
                   "forward_senet_memory": _np(jax.jit(
                       lambda v, i, p, k, m: jm_se.apply(
                           v, i, p, k, memory=m, use_est=True,
                           train=False))(variables_se, *win,
                                         _jax_memory(memory))[0])}
        with pytest.MonkeyPatch.context() as mp:  # the fused Pallas kernel
            mp.setenv("ESTDEPTH_FUSED_WARP", "1")
            jax_out["two_pass_sweep"] = np.asarray(jwarp.plane_sweep_warp(
                sweep["feat"], sweep["src_proj"], sweep["ref_proj"],
                sweep["dvals"], backend="pallas"))
        jmem = JaxMemory.create(1, 2, ND, H // 4, W // 4)
        chain = []
        for i in range(3):
            w = (imgs[:, i:i + 3], poses[:, i:i + 3], intr)
            out, state = (apply(variables, *w) if i == 0
                          else apply_mem(variables, *w, jmem))
            jmem = jmem.push(*state)
            chain.append(np.asarray(out["depth"]))
        jax_out["chain"] = np.stack(chain, 1)
        # ---- the port, unsharded -----------------------------------------
        port = {}
        for case, (cfg, with_memory) in FORWARD_CASES.items():
            model = _port_model(tm_se if cfg.get("feature_net") else tm,
                                **cfg)
            port[case] = _np(_port_forward(
                model, *win, _port_memory(memory) if with_memory else None))
        port["bf16"] = _np(_port_forward(
            _port_model(tm, compute_dtype="bfloat16"), *win,
            _port_memory(memory, torch.bfloat16)))
        # ---- the primitives, unsharded -----------------------------------
        inputs = torch.load(tmp / "inputs.pt", weights_only=True)
        prims = {}
        with torch.inference_mode():
            for name, (make, _) in PRIMITIVES.items():
                layer = make()
                layer.load_state_dict(inputs["primitive_states"][name])
                prims[name] = layer(inputs["primitive_inputs"][name])
            prims["psm_pyramid"] = pyramid(
                tm.matchingFeature, inputs["pyramid_raw"],
                inputs["pyramid_skip"])
    finally:
        for procs in launched.values():
            _finish(procs)
    sharded = {world: torch.load(tmp / str(world) / "results.pt",
                                 weights_only=True) for world in WORLDS}
    return dict(sharded=sharded, jax=jax_out, port=port, primitives=prims,
                tm=tm, jm=jm, variables=variables, memory=memory,
                window=win)


@pytest.mark.parametrize("name", [*PRIMITIVES, "psm_pyramid"])
@pytest.mark.parametrize("world", WORLDS)
def test_primitive_matches_its_unsharded_call(runs, world, name):
    got = runs["sharded"][world]["primitives"][name]
    want = runs["primitives"][name]
    assert got.shape == want.shape
    assert float(want.abs().max()) > 0.1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_two_pass_sweep_matches_pallas(runs, world):
    """Kernel 3's plain version at each rank's output window, gathered,
    against the JAX package's fused two-pass Pallas kernel on the whole
    map (tests/test_torch_port_two_pass.py's tolerance)."""
    got = runs["sharded"][world]["primitives"]["two_pass_sweep"].numpy()
    want = runs["jax"]["two_pass_sweep"]
    assert got.shape == want.shape == (1, 16, 16, W // 4, 8)
    assert (want == 0).all(-1).any() and (want != 0).all(-1).any()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-4 * scale)


@pytest.mark.parametrize("world", WORLDS)
def test_shard_and_gather_round_trips(runs, world):
    assert runs["sharded"][world]["primitives"]["round_trips"] == [True] * len(
        ROUND_TRIPS)


def _expected_calls(cfg: dict, est: bool) -> dict:
    """Collectives of one window: a halo for every convolution (and the
    max-pool) wider than one column, 2 more in EST; a gather of the
    matching features, and of the K/V volumes in EST; the pyramid's one
    all_reduce, the 12 SE gates' of the SENet encoder and the 3
    GroupNorms' two each in EST. The SENet encoder has 17 convolutions
    wider than a column (its stem's 3, the 12 blocks' 3x3, layer2's 3x3
    shortcut, the head's 3x3) where PSM's has 54."""
    senet = cfg.get("feature_net") == "senet"
    return {"halo": (58 if senet else 95) + 2 * est, "gather": 1 + est,
            "all_reduce": 1 + 12 * senet + 6 * est}


@pytest.mark.parametrize("case", FORWARD_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_forward_matches_the_unsharded_port(runs, world, case):
    got = _np(runs["sharded"][world][case])
    want = runs["port"][case]
    assert got["depth"].shape == (1, 1, 4, H, W)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=0,
                               atol=1e-4)
    for k in ("init_prob", "fused_prob"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    for k in ("key", "value"):  # the state pushed into the memory
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    cfg, est = FORWARD_CASES[case]
    if est:  # EST fused the memory
        assert np.abs(got["depth"][:, :, 2] - got["depth"][:, :, 3]).max(
            ) > 1e-3
    calls = runs["sharded"][world][case]["calls"]
    assert calls == _expected_calls(cfg, est), calls


@pytest.mark.parametrize("case", JAX_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_forward_matches_jax(runs, world, case):
    got = _np(runs["sharded"][world][case])
    want = runs["jax"][case]
    for k in ("depth", "init_prob", "fused_prob"):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=JAX_CASES[case], err_msg=k)


def test_sharded_chain_matches_jax(runs):
    got = runs["sharded"][2]["chain"]["depth"].numpy()
    assert got.shape == (1, 3, 1, 4, H, W)
    np.testing.assert_allclose(got, runs["jax"]["chain"], rtol=0,
                               atol=8e-3)


def test_sharded_bf16_forward_within_twice_bf16s_own_distance(runs):
    got = _np(runs["sharded"][2]["bf16"])
    want, f32 = runs["port"]["bf16"], runs["port"]["forward_memory"]
    for k in ("depth", "init_prob", "fused_prob"):
        own = float(np.abs(want[k] - f32[k]).max())
        err = float(np.abs(got[k] - want[k]).max())
        assert 0 < own and err <= 2 * own, (k, err, own)


def _one_rank():
    return Mesh(None, 0, 1, torch.device("cpu"))


def test_layout_limit_and_shards():
    """Shards on the 32-px grid: 96 px over 2 ranks are 32 + 64, over 3
    ranks 32 each; more ranks than 32-px columns raise, also for a mesh
    of 4 ranks at W = 96."""
    assert {s: spatial.shard_bounds(96, s) for s in (1, 2, 3)} == {
        1: [(0, 96)], 2: [(0, 32), (32, 96)],
        3: [(0, 32), (32, 64), (64, 96)]}
    with pytest.raises(ValueError, match="at most 3 ranks"):
        spatial.WidthShards(Mesh(None, 0, 4, torch.device("cpu")), 96)
    assert len(spatial.shard_bounds(320, 10)) == 10
    with pytest.raises(ValueError, match="at most 10 ranks"):
        spatial.shard_bounds(320, 11)
    with pytest.raises(ValueError, match="multiple of 32"):
        spatial.WidthShards(_one_rank(), 100)


def test_one_rank_is_the_unsharded_forward(runs):
    """At world size 1 the halos are the convolutions' own zero padding."""
    fn = spatial.make_spatial_window_fn(runs["tm"], _one_rank(),
                                        with_memory=True)
    imgs, poses, intr = (torch.from_numpy(a) for a in runs["window"])
    got, _ = fn(imgs, poses, intr, _port_memory(runs["memory"]))
    want = runs["port"]["forward_memory"]
    for k in ("depth", "init_prob", "fused_prob"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-5, err_msg=k)
    assert fn.stats.calls == {}  # nothing to exchange


def test_sharded_forward_is_eval_only(runs):
    imgs, poses, intr = (torch.from_numpy(a) for a in runs["window"])
    with pytest.raises(ValueError, match="eval only"):
        with spatial.width_sharded(spatial.WidthShards(_one_rank(), W)):
            runs["tm"](imgs, poses, intr, train=True)


@pytest.mark.slow
def test_sharded_forward_matches_jaxs_sharded_function(runs):
    """JAX's own width-sharded function (GSPMD on create_mesh(2) of the
    conftest's CPU devices) against the port's 2 ranks."""
    mesh = jax_create_mesh(2)
    win = runs["window"]
    got = _np(runs["sharded"][2]["forward_memory"])
    want, _ = jax_spatial_window_fn(runs["jm"], mesh, with_memory=True)(
        runs["variables"], *map(jnp.asarray, win),
        _jax_memory(runs["memory"]))
    np.testing.assert_allclose(got["depth"], np.asarray(want["depth"]),
                               rtol=0, atol=5e-3)
    want, _ = jax_spatial_window_fn(runs["jm"], mesh)(
        runs["variables"], *map(jnp.asarray, win))
    np.testing.assert_allclose(_np(runs["sharded"][2]["forward"])["depth"],
                               np.asarray(want["depth"]), rtol=0, atol=5e-3)
