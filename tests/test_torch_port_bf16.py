"""The port's bf16 model against the JAX package's on CPU.

`ModelConfig(compute_dtype="bfloat16")` is the port of the JAX package's
production configuration, `DepthNetHybrid(dtype=jnp.bfloat16)`: the
parameters, BatchNorm's statistics, the softmaxes and the depth heads stay
float32, the activations, the K/V volumes and the ESTM memory are
bfloat16. Held here:

  * the three checks of tests/test_bf16.py on the port (state and outputs
    follow the model dtype, a memory whose dtype is stable across pushes,
    the sequence processor's bfloat16 fetch);
  * each kernel's plain bf16 version (upcast, the float32 plain version,
    one rounding) against the JAX Pallas function on the same bf16 inputs
    in interpret mode, as the JAX tests run them: the packed plane sweep
    (kernel 1), the exact-z frustum warp (kernel 2, packed=False), the
    fused two-pass resample (kernel 3, ESTDEPTH_FUSED_WARP=1), the packed
    plane-mix warp (kernel 4) and the attention (kernel 5). Under pure
    translations, where the TPU's two-pass forms are the exact sample, the
    only differences are roundings: the TPU kernels round their
    intermediates to bf16 where the port keeps float32. The bounds are a
    bf16 ulp or two, inside the JAX tests' own 4e-2 / 6e-2
    (tests/test_pallas_warp.py:205-240), and each states the maximum
    measured here;
  * `apply_exact_z_correction` with a `z_origin` against JAX's;
  * the encoders, the cost volume and the EST fusion step: the port's
    bf16 against JAX's bf16 at the same weights within twice JAX's own
    bf16-against-float32 distance in the same test ("the two packages
    agree in bf16 as well as bf16 agrees with float32"). bf16 rounds at
    other places in the two frameworks (XLA's bf16 elementwise chains and
    reductions, the BatchNorm JAX evaluates as four bf16 steps where
    PyTorch's fused kernel rounds once), so bit agreement is not the
    measure (the cost volume's backward in train mode is held so in
    tests/test_torch_port_bf16_grad.py);
  * a bf16 volume's gradient through a kernel wrapper (bf16, autograd of
    the plain version);
  * only half volumes are upcast: the samplers and the plain versions keep
    a float64 volume in float64.

The slice as a whole (a bf16 ESTM stream, a Joint chain, the eval and
export tools) is held in tests/test_torch_port_bf16_slice.py, the training
steps in tests/test_torch_port_bf16_train.py: three files of about a
minute each on one worker.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.models.est_transformer import EpipolarTransformer as JaxEST
from estdepth_tpu.models.psm import PSMFeatureNet as JaxPSM
from estdepth_tpu.models.resnet import ResNetEncoder as JaxResNet
from estdepth_tpu.ops import geometry as jgeo
from estdepth_tpu.ops import warp as jwarp
from estdepth_tpu.ops import warp_exact_z as jez
from estdepth_tpu.ops.pallas.epipolar_attention import (
    epipolar_attention as jax_attention,
)
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.eval.sequence import (
    SequenceProcessor, make_sequence_processor,
)
from estdepth_tpu_torch.models.est_transformer import EpipolarTransformer
from estdepth_tpu_torch.ops import geometry as tgeo
from estdepth_tpu_torch.ops import warp as twarp
from estdepth_tpu_torch.ops import warp_exact_z as tez
from estdepth_tpu_torch.ops.cuda import epipolar_attention, plane_warp
from estdepth_tpu_torch.ops.cuda.plane_mix import plane_mix_resample_plain
from estdepth_tpu_torch.ops.cuda.two_pass import two_pass_resample_plain
from estdepth_tpu_torch.ops.sampling import bilinear_sample, trilinear_sample
from estdepth_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_common import (
    DMAX, DMIN, H, ND, W, bf16_models, pitched_frames, random_variables,
    scene_arrays,
)
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BF16 = jnp.bfloat16
# tests/test_torch_port_ops.py's sweep and frustum setup
SWEEP_D, FRUSTUM_D = 16, 16
DINT = (DMAX - DMIN) / (FRUSTUM_D - 1)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _max(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def _pose(tx=0.0, ty=0.0, tz=0.0):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [tx, ty, tz]
    return m[None]


def _intr(h, w, f):
    return np.array([[[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]]],
                    np.float32)


def _ulp(scale: float) -> float:
    """The spacing of bf16 numbers at `scale`."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


# ---- the three checks of tests/test_bf16.py, on the port -----------------


@pytest.fixture(scope="module")
def bf16_pair():
    return bf16_models(views=3)


def test_state_and_outputs_follow_model_dtype(bf16_pair):
    """key/value bf16 (so ESTMemory.push stays promotion-free), depth
    float32 and finite; the parameters and BatchNorm's running statistics
    stay float32."""
    _, _, _, tm = bf16_pair
    imgs, poses, intr = scene_arrays(3)
    with torch.inference_mode():
        outputs, (key, value, _) = tm(_t(imgs[None]), _t(poses[None]),
                                      _t(intr[None]))
    assert key.dtype == value.dtype == torch.bfloat16
    assert outputs["depth"].dtype == torch.float32
    assert outputs["init_prob"].dtype == torch.float32
    assert bool(torch.isfinite(outputs["depth"]).all())
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(b.dtype in (torch.float32, torch.int64) for b in tm.buffers())


def test_streaming_memory_dtype_stable(bf16_pair):
    _, _, _, tm = bf16_pair
    runner = ESTMRunner(tm, H, W, lwindow=3, memory_size=2, device="cpu")
    assert runner.memory.keys.dtype == torch.bfloat16
    out = None
    for f in pitched_frames(4):
        out = runner.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
    assert out is not None and bool(torch.isfinite(out).all())
    assert runner.memory.keys.dtype == torch.bfloat16
    assert runner.memory.values.dtype == torch.bfloat16
    assert bool(runner.memory.valid.all())


def test_sequence_processors_fetch_bf16(bf16_pair):
    """make_sequence_processor returns (1, 3, 2, h, w) bfloat16 on the
    device; SequenceProcessor fetches the same maps as bfloat16 and gives
    them as float32 on the host (numpy has no bfloat16)."""
    _, _, _, tm = bf16_pair
    imgs, poses, intr = scene_arrays(5)
    proc = make_sequence_processor(tm, 3, 2, output_scales=(0, 2),
                                   output_dtype=torch.bfloat16, device="cpu")
    d = proc(imgs[None], poses[None], intr[None])
    assert d.shape == (1, 3, 2, H, W) and d.dtype == torch.bfloat16
    assert bool(torch.isfinite(d.float()).all())
    host = SequenceProcessor(tm, 3, 2, chunk=4, output_scales=(0, 2),
                             output_dtype=torch.bfloat16,
                             device="cpu").process_scene(imgs, poses, intr)
    assert host.dtype == np.float32
    np.testing.assert_array_equal(host, d[0].float().numpy())


# ---- the kernels' plain bf16 versions against the JAX Pallas functions ---


def _sweep_inputs(c):
    rng = np.random.default_rng(7)
    h, w = 16, 20
    feat = rng.normal(size=(1, h, w, c)).astype(np.float32)
    feat = np.asarray(jnp.asarray(feat, BF16).astype(jnp.float32))
    intr = _intr(h, w, 18.0)
    dvals = np.linspace(DMIN, DMAX, SWEEP_D, dtype=np.float32)[None]
    return feat, intr, dvals


TRANSLATIONS = [_pose(tx=0.05), _pose(ty=-0.04, tz=0.08)]


@pytest.mark.parametrize("two_pass", [False, True])
def test_plane_sweep_plain_bf16_matches_pallas(monkeypatch, two_pass):
    """Kernel 1 (the packed plane_sweep_warp_pallas) and, with
    `two_pass`, kernel 3 (the packed fused _two_pass under
    ESTDEPTH_FUSED_WARP=1), on a unit-normal bf16 map under pure
    translations: the JAX kernels round their pass-1 image to bf16 and the
    port does not, so they differ by a rounding of the intermediate and one
    of the result. Held to 2 bf16 ulps of max(|value|, 1) for each value
    and to the JAX test's 4e-2 overall; measured at most 1 ulp, 0.0156
    (values up to 3.7)."""
    if two_pass:
        monkeypatch.setenv("ESTDEPTH_FUSED_WARP", "1")
    feat, intr, dvals = _sweep_inputs(c=8 if two_pass else 16)
    ref_proj = jgeo.camera_projection(intr, _pose())
    worst = 0.0
    for pose in TRANSLATIONS:
        src_proj = jgeo.camera_projection(intr, pose)
        want = jwarp.plane_sweep_warp(jnp.asarray(feat, BF16), src_proj,
                                      ref_proj, dvals, backend="pallas")
        got = twarp.plane_sweep_warp(
            _t(feat, torch.bfloat16), _t(src_proj), _t(ref_proj), _t(dvals),
            two_pass=two_pass)
        assert want.dtype == BF16 and got.dtype == torch.bfloat16
        g, w = _np(got), _np(want)
        bound = 2 * np.vectorize(_ulp)(np.maximum(np.abs(w), 1.0))
        assert (np.abs(g - w) <= bound).all(), np.abs(g - w).max()
        worst = max(worst, float(np.abs(g - w).max()))
    assert worst < 4e-2


def _frustum_volume(c=8):
    rng = np.random.default_rng(5)
    vol = rng.normal(size=(1, FRUSTUM_D, 16, 20, c)).astype(np.float32)
    return np.asarray(jnp.asarray(vol, BF16).astype(jnp.float32))


@pytest.mark.parametrize("mode", ["plane_mix", "plane_mix_exact_z"])
def test_frustum_plain_bf16_matches_pallas(mode):
    """Kernel 4 (the packed frustum_warp_pallas) and kernel 2
    (frustum_warp_exact_z_pallas, packed=False) on a unit-normal bf16
    volume under pure translations, where the TPU's two-pass sample is the
    exact one: kernel 4's JAX form rounds its z-mixed and pass-1
    intermediates to bf16, kernel 2 keeps A and s float32 in both. Held to
    one bf16 ulp of the volume's scale (0.031 at |v| up to 4.3), half the
    JAX test's 6e-2; measured 0.0156 for both kernels."""
    vol = _frustum_volume()
    intr = _intr(16, 20, 18.0)
    dv = np.linspace(DMIN, DMAX, FRUSTUM_D, dtype=np.float32)[None]
    worst = 0.0
    for rel in ([_pose(tx=0.07)] + [_pose(tx=-0.03, ty=0.06)]):
        want = jwarp.frustum_warp(jnp.asarray(vol, BF16), rel, intr, dv,
                                  DMIN, DINT, mode=mode.replace(
                                      "plane_mix", "plane_mix_pallas"))
        got = twarp.frustum_warp(_t(vol, torch.bfloat16), _t(rel), _t(intr),
                                 _t(dv), DMIN, DINT, mode=mode)
        assert want.dtype == BF16 and got.dtype == torch.bfloat16
        worst = max(worst, _max(got, want))
    assert worst <= _ulp(np.abs(vol).max()), worst


def test_attention_plain_bf16_matches_pallas():
    """Kernel 5 on bf16 warped values (and keys): the JAX kernel computes
    in float32 and rounds its output once, as the port's plain version
    does; the two sum in other orders, so they may round to neighbouring
    bf16 numbers: held within one ulp of each value, measured equal."""
    rng = np.random.default_rng(0)
    n, s, p, c = 3, 6, 256, 16
    tk, wk, wv = (np.asarray(jnp.asarray(rng.normal(size=shape), BF16))
                  for shape in ((s, p, c), (n, s, p, c), (n, s, p, c)))
    valid = rng.uniform(size=(n, s)) > 0.3
    valid[:, 0] = True
    valid[:, 2] = False
    want = jax_attention(*map(jnp.asarray, (tk, wk, wv, valid)),
                         interpret=True)
    got = epipolar_attention.epipolar_attention_plain(
        *(_t(a, torch.bfloat16) for a in (tk, wk, wv)),
        torch.from_numpy(valid))
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    g, w = _np(got), _np(want)
    assert (np.abs(g - w) <= np.vectorize(_ulp)(
        np.maximum(np.abs(w), 2.0 ** -126))).all()
    assert np.abs(g[2]).max() == 0.0  # no valid neighbour: exactly 0


def test_apply_exact_z_correction_with_z_origin_matches_jax():
    """A shifted A-field origin (A = v0 + (z_origin - z0) s, the JAX
    package's conditioning for its packed TPU transport): JAX's result at
    float32 noise, rounded once to bf16 as JAX rounds it, and the same
    function as origin 0 up to float32 noise."""
    rng = np.random.default_rng(9)
    p, n, c, d = 3, 50, 8, 16
    zi_star = rng.uniform(-0.5, d - 0.5, size=(p, n)).astype(np.float32)
    s = rng.normal(size=(p, n, c)).astype(np.float32)
    a0 = rng.normal(size=(p, n, c)).astype(np.float32)
    origin = np.array([2.0, 7.5, 11.0], np.float32)
    shifted = (a0 + origin[:, None, None] * s).astype(np.float32)
    got = {}
    for dtype, tdtype in ((jnp.float32, torch.float32),
                          (BF16, torch.bfloat16)):
        want = jez.apply_exact_z_correction(
            jnp.asarray(shifted), jnp.asarray(s), jnp.asarray(zi_star), d,
            dtype, z_origin=jnp.asarray(origin))
        got[tdtype] = tez.apply_exact_z_correction(
            _t(shifted), _t(s), _t(zi_star), d, tdtype, z_origin=_t(origin))
        assert got[tdtype].dtype == tdtype
        scale = np.abs(_np(want)).max()
        # float32: 1e-6 of the scale; bf16: the same float32 sum rounded
        # once on each side, so at most one ulp apart where the sums round
        # to neighbours
        tol = 1e-6 * scale if dtype == jnp.float32 else _ulp(scale)
        assert _max(got[tdtype], want) <= tol
    base = tez.apply_exact_z_correction(_t(a0), _t(s), _t(zi_star), d,
                                        torch.float32)
    assert _max(got[torch.float32], base) <= 1e-5 * np.abs(_np(base)).max()
    assert bool((base == 0).any())  # voxels outside the z window


def test_wrapper_gives_a_bf16_volume_a_bf16_gradient():
    """sample_with_plain_grad on a bf16 volume: the gradient is bf16 and
    is autograd of the plain version."""
    feat, intr, dvals = _sweep_inputs(c=8)
    proj = tgeo.camera_projection(_t(intr), _t(_pose(tx=0.05)))
    ref = tgeo.camera_projection(_t(intr), _t(_pose()))
    x, y = twarp.plane_sweep_coords(proj, ref, _t(dvals), 16, 20)
    ct = torch.randn(1, SWEEP_D, 16, 20, 8,
                     generator=torch.Generator().manual_seed(0)).bfloat16()
    with torch.enable_grad():
        src = _t(feat, torch.bfloat16).requires_grad_()
        plane_warp.plane_sweep_sample(src, x, y).backward(ct)
        leaf = _t(feat, torch.bfloat16).requires_grad_()
        (want,) = torch.autograd.grad(
            plane_warp.plane_sweep_sample_plain(leaf, x, y), leaf, ct)
    assert src.grad.dtype == torch.bfloat16
    assert torch.equal(src.grad, want)


def _float64_cases():
    """name -> fn(volume dtype) for the samplers and the plain versions of
    kernels 1, 3, 4 and 5, on one set of float64 inputs."""
    gen = np.random.default_rng(0)
    b, d, h, w, c = 2, 3, 5, 6, 16
    vol = torch.from_numpy(gen.normal(size=(b, d, h, w, c)))
    x = torch.from_numpy(gen.uniform(-0.5, w - 0.5, (b, d * h * w)))
    y = torch.from_numpy(gen.uniform(-0.5, h - 0.5, (b, d * h * w)))
    z = torch.from_numpy(gen.uniform(-0.5, d - 0.5, (b, d * h * w)))
    zi = torch.from_numpy(gen.uniform(-0.5, d - 0.5, (b, d, h * w)))
    pw = x.reshape(b * d, h * w)
    ab = torch.from_numpy(gen.uniform(-0.1, 0.1, (b * d, 2, w)))
    tk, wk, wv = (torch.from_numpy(gen.normal(size=shape)) for shape in
                  ((b * h, w, c), (d, b * h, w, c), (d, b * h, w, c)))
    valid = torch.from_numpy(gen.uniform(size=(d, b * h)) > 0.3)
    return {
        "bilinear": lambda dt: bilinear_sample(vol[:, 0].to(dt), x[:, :h * w],
                                               y[:, :h * w]),
        "trilinear": lambda dt: trilinear_sample(vol.to(dt), x, y, z),
        "plane_sweep": lambda dt: plane_warp.plane_sweep_sample_plain(
            vol[:, 0].to(dt), x, y),
        "two_pass": lambda dt: two_pass_resample_plain(
            vol.reshape(b * d, h, w, c).to(dt), ab, pw,
            y.reshape(b * d, h * w), 1),
        "plane_mix": lambda dt: plane_mix_resample_plain(
            vol.to(dt), zi, x, y),
        "attention": lambda dt: epipolar_attention.epipolar_attention_plain(
            tk.to(dt), wk.to(dt), wv.to(dt), valid),
    }


@pytest.mark.parametrize("name", ["bilinear", "trilinear", "plane_sweep",
                                  "two_pass", "plane_mix", "attention"])
def test_plain_versions_keep_float64(name):
    """Only a half volume (bfloat16, float16) is upcast to float32: a
    float64 volume is sampled in float64, as a float64 run of the model
    needs, and a float32 one exactly as before."""
    fn = _float64_cases()[name]
    out64, out32 = fn(torch.float64), fn(torch.float32)
    assert out64.dtype == torch.float64 and out32.dtype == torch.float32
    # float32 rounding noise apart, and not a float32 result widened
    err = (out64 - out32.double()).abs().max().item()
    assert 0 < err <= 1e-5 * out64.abs().max().item()


# ---- modules, the stream and the Joint chain: port bf16 vs JAX bf16 -----


def _sub(variables, name):
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"][name]}


def _within_twice_jax_bf16(got, want_bf16, want_f32, what):
    """max |port bf16 - JAX bf16| <= 2 max |JAX bf16 - JAX float32|."""
    own = _max(want_bf16, want_f32)
    err = _max(got, want_bf16)
    assert own > 0, what
    assert err <= 2 * own, (what, err, own)
    return err / own


def test_encoders_bf16_match_jax(bf16_pair):
    """The PSM matching encoder (its frames cast to bf16 after the
    normalization) and the ResNet-18 encoder, all five maps: measured
    ratios 1.09 (PSM) and 0.66 to 1.17."""
    _, _, variables, tm = bf16_pair
    imgs = np.stack([f["img"] for f in pitched_frames(2)])
    x = jnp.asarray(2.0 * (imgs / 255.0) - 1.0, jnp.float32)
    psm = {dt: np.asarray(JaxPSM(dtype=dt).apply(
        _sub(variables, "matching_feature"), x.astype(dt or jnp.float32)),
        np.float32) for dt in (BF16, None)}
    with torch.inference_mode():
        got = tm.compute_matching(torch.from_numpy(imgs))
    assert got.dtype == torch.bfloat16
    _within_twice_jax_bf16(got, psm[BF16], psm[None], "psm")
    res = {dt: JaxResNet(18, dtype=dt).apply(
        _sub(variables, "semantic_feature"), x.astype(dt or jnp.float32))
        for dt in (BF16, None)}
    with torch.inference_mode():
        maps = tm.semanticFeature(torch.from_numpy(np.asarray(x)).bfloat16()
                                  .permute(0, 3, 1, 2))
    for i, g in enumerate(maps):
        assert g.dtype == torch.bfloat16
        _within_twice_jax_bf16(g.permute(0, 2, 3, 1), res[BF16][i],
                               res[None][i], f"resnet map {i}")


def test_cost_volume_bf16_matches_jax(bf16_pair):
    """The plane sweep of bf16 matching features and the pre-stack
    (pre0, residual pre2 . pre1, mean over the two neighbours): measured
    ratio 0.89."""
    jm, jm32, variables, tm = bf16_pair
    imgs, poses, intr = scene_arrays(3)
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(1, 3, H // 4, W // 4, 32)).astype(np.float32)
    feats = np.asarray(jnp.asarray(feats, BF16).astype(jnp.float32))
    k4 = np.asarray(jgeo.scale_intrinsics(intr[None], 0.25))
    dv = np.linspace(DMIN, DMAX, ND, dtype=np.float32)[None]

    def jax_cost(model, dt):
        return np.asarray(model.apply(
            variables, jnp.asarray(feats, dt), jnp.asarray(poses[None]),
            jnp.asarray(k4), jnp.asarray(dv), False,
            method=lambda m, *a: m._cost_volumes(*a)), np.float32)

    with torch.inference_mode():
        got = tm._cost_volumes(_t(feats, torch.bfloat16), _t(poses[None]),
                               _t(k4), _t(dv))
    assert got.dtype == torch.bfloat16
    _within_twice_jax_bf16(got.permute(0, 1, 3, 4, 5, 2),
                           jax_cost(jm, BF16), jax_cost(jm32, jnp.float32),
                           "cost volume")


def test_est_fusion_step_bf16_matches_jax():
    """The EST transformer on bf16 K/V volumes with a masked neighbour:
    GroupNorm in float32 and rounded once, the gates and the GRU update
    in bf16, the attention logits float32: measured ratio 1.09."""
    rng = np.random.default_rng(3)
    b, d, h, w, c, n = 1, 4, 5, 6, 16, 3
    tk, tv = (rng.normal(size=(b, d, h, w, c)).astype(np.float32)
              for _ in range(2))
    wk, wv = (rng.normal(size=(n, b, d, h, w, c)).astype(np.float32)
              for _ in range(2))
    tk, tv, wk, wv = (np.asarray(jnp.asarray(a, BF16).astype(jnp.float32))
                      for a in (tk, tv, wk, wv))
    valid = np.array([[True], [False], [True]])
    variables = random_variables(lambda: JaxEST(c).init(
        jax.random.key(0), *map(jnp.asarray, (tk, tv, wk, wv, valid))),
        seed=4)
    want = {dt: np.asarray(JaxEST(c, dtype=dt).apply(
        variables, *(jnp.asarray(a, dt or jnp.float32)
                     for a in (tk, tv, wk, wv)), jnp.asarray(valid)),
        np.float32) for dt in (BF16, None)}
    tmod = EpipolarTransformer(c)
    prefix = "CostRegNet.epipolar_transformer."
    sd = state_dict_from_jax({"params": {"decoder": {
        "est": variables["params"]}}})
    tmod.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                         strict=True)
    with torch.inference_mode():
        got = tmod(*(_t(a, torch.bfloat16) for a in (tk, tv, wk, wv)),
                   torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    _within_twice_jax_bf16(got, want[BF16], want[None], "est fusion")
