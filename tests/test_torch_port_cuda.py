"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips where no CUDA device is present (decided in
the fixture, not at import). On a machine with the card:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest

The four warp kernels repeat their plain version's arithmetic operation
by operation (no FMA contraction) and are held to it bit for bit
(`torch.equal`), in both instances; chip_smoke.py holds them so at the
flagship shapes, and the frustum warps also at a rolled pose.
Their gradients on the card are autograd of the plain versions, held to
autograd of the plain version called directly at 3e-5 of the gradient's
scale (both scatter-add with float atomics, in an order that changes from
run to run; chip_smoke.py measures up to 5.3e-6 at the flagship shapes).
The attention kernel sums its 16 channels and its softmax in another order
than PyTorch's reductions, so it is held to rtol 1e-5 / atol 1e-6, the
tolerance the JAX package holds its TPU kernel to (tests/test_pallas.py).
The ESTM tool's dataset path (a scene written by data/png.py, a reference
checkpoint) is held against its CPU run at the chain tolerance 8e-3. A
serving artifact exported on the CPU and loaded onto the card launches
the kernels from its op nodes and equals a card ESTMRunner within 1e-5.
The PSM matching encoder, under its measured cuDNN plans, stays float32
(no TF32 kernel) and within 1e-4 of its scale of the CPU's features.
Without JAX on the card's machine, run with `--noconftest`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from estdepth_tpu_torch.ops import geometry, warp
from estdepth_tpu_torch.ops.cuda import (
    epipolar_attention, plane_mix, plane_warp, plane_warp_exact_z, two_pass,
)
from estdepth_tpu_torch.ops.warp_exact_z import resample_exact_z, zi_field

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pose(tx, ty, tz, yaw, pitch, roll=0.0):
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                 @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
                 @ np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]]))
    m[:3, 3] = [tx, ty, tz]
    return torch.from_numpy(m)


def _setup(dev, h=24, w=32, d=16, c=8, b=2):
    k = torch.tensor([[[30.0, 0, (w - 1) / 2], [0, 30.0, (h - 1) / 2],
                       [0, 0, 1]]], device=dev).expand(b, 3, 3)
    poses = torch.stack([_pose(0.05, -0.02, 0.03, 0.02, -0.01),
                         _pose(-0.04, 0.03, -0.05, -0.015, 0.02)]).to(dev)
    dv = torch.linspace(0.5, 8.0, d, device=dev)[None].expand(b, d)
    return k, poses, dv


@pytest.mark.parametrize("c,w", [(4, 32), (8, 32), (32, 32), (64, 32),
                                 (8, 33), (12, 31)])
def test_plane_sweep_kernel_matches_plain(dev, c, w):
    """Bit for bit, at each channel count the kernel has an instance for,
    an odd width, and a C / 4 it takes through its generic instance."""
    b, h, d = 2, 24, 16
    k, poses, dv = _setup(dev, h, w, d, c, b)
    src = torch.randn(b, h, w, c, generator=torch.Generator().manual_seed(0))
    src = src.to(dev)
    proj = geometry.camera_projection(k, poses)
    ref = geometry.camera_projection(k, torch.eye(4, device=dev).expand(
        b, 4, 4))
    x, y = warp.plane_sweep_coords(proj, ref, dv, h, w)
    before = plane_warp.KERNEL.launches
    got = plane_warp.plane_sweep_sample(src, x, y)
    assert plane_warp.KERNEL.launches == before + 1
    assert torch.equal(got, plane_warp.plane_sweep_sample_plain(src, x, y))
    assert (got == 0).any() and (got != 0).any()


# channel counts of the frustum warps' instances (C / 4 = 1, 2, 8, 16 and
# the generic 3), an odd width, and a width that fills the tiles
FRUSTUM_SHAPES = [(4, 32), (8, 32), (12, 31), (32, 32), (64, 32), (8, 33)]


def _frustum_inputs(dev, c, w, dtype=torch.float32, rolled=False, seed=1):
    """A volume and the frustum coordinates and zi field of _setup's poses
    (or, `rolled`, poses rolled 0.4 rad about the optical axis and moved
    1.0 forward: slanted rows, voxels leaving the image, and some zi carry
    the -2 sentinel)."""
    b, h, d = 2, 24, 16
    k, poses, dv = _setup(dev, h, w, d, c, b)
    if rolled:
        poses = torch.stack([_pose(0.05, -0.02, 1.0, 0.02, -0.01, 0.4),
                             _pose(-0.04, 0.03, 1.0, -0.015, 0.02, -0.4)]
                            ).to(dev)
    vol = torch.randn(b, d, h, w, c, generator=torch.Generator().manual_seed(
        seed)).to(dev).to(dtype)
    dint = (8.0 - 0.5) / (d - 1)
    t, grid, x, y, z = warp.frustum_coords(poses, k, dv, h, w)
    zi = zi_field(t, k, dv, 0.5, dint, grid)
    return vol, zi, x, y, z, dint


@pytest.mark.parametrize("c,w", FRUSTUM_SHAPES)
def test_exact_z_kernel_matches_plain(dev, c, w):
    """Bit for bit, at each channel count the kernel has an instance for,
    a C / 4 it takes through its generic instance and an odd width."""
    vol, zi, x, y, z, dint = _frustum_inputs(dev, c, w)
    before = plane_warp_exact_z.KERNEL.launches
    got = plane_warp_exact_z.exact_z_resample(vol, zi, x, y, z, 0.5, dint)
    assert plane_warp_exact_z.KERNEL.launches == before + 1
    assert torch.equal(got, resample_exact_z(vol, zi, x, y, z, 0.5, dint))
    assert (got == 0).any() and (got != 0).any()


def test_kernels_refuse_bf16_and_bad_shapes(dev):
    """Since the bf16 model a bfloat16 volume launches the kernel's bf16
    instance (and equals the plain version, the bf16 tests below); a
    float16 volume, bfloat16 coordinates and ragged channels still
    raise."""
    vol = torch.zeros(1, 4, 6, 8, 8, device=dev)
    coords = torch.zeros(1, 4 * 6 * 8, device=dev)
    zi = torch.zeros(1, 4, 48, device=dev)
    before = plane_warp_exact_z.KERNEL.launches_bf16
    out = plane_warp_exact_z.exact_z_resample(vol.bfloat16(), zi, coords,
                                              coords, coords, 0.5, 0.1)
    assert out.dtype == torch.bfloat16
    assert plane_warp_exact_z.KERNEL.launches_bf16 == before + 1
    with pytest.raises(TypeError):
        plane_warp_exact_z.exact_z_resample(vol.half(), zi, coords,
                                            coords, coords, 0.5, 0.1)
    with pytest.raises(TypeError):
        plane_warp_exact_z.exact_z_resample(vol, zi, coords.bfloat16(),
                                            coords, coords, 0.5, 0.1)
    with pytest.raises(ValueError):
        plane_warp_exact_z.exact_z_resample(vol[..., :6].contiguous(), zi,
                                            coords, coords, coords, 0.5, 0.1)
    with pytest.raises(ValueError):  # 4 bf16 channels: half a vector
        plane_warp_exact_z.exact_z_resample(
            vol[..., :4].contiguous().bfloat16(), zi, coords, coords,
            coords, 0.5, 0.1)
    with pytest.raises(ValueError):
        plane_warp.plane_sweep_sample(vol[0, 0], coords[:, :-1],
                                      coords[:, :-1])


@pytest.mark.parametrize("c,w", FRUSTUM_SHAPES)
def test_plane_mix_kernel_matches_plain(dev, c, w):
    """Bit for bit, at the shapes of the exact-z kernel's test."""
    vol, zi, x, y, _, dint = _frustum_inputs(dev, c, w, seed=2)
    before = plane_mix.KERNEL.launches
    got = plane_mix.plane_mix_resample(vol, zi, x, y)
    assert plane_mix.KERNEL.launches == before + 1
    assert torch.equal(got, plane_mix.plane_mix_resample_plain(vol, zi, x, y))
    assert (got == 0).any() and (got != 0).any()
    # the same through the public warp
    k, poses, dv = _setup(dev, 24, w, 16, c, 2)
    assert torch.equal(
        warp.frustum_warp(vol, poses, k, dv, 0.5, dint, mode="plane_mix"),
        got)
    assert plane_mix.KERNEL.launches == before + 2


@pytest.mark.parametrize("dtype,c", [(torch.float32, 32),
                                     (torch.bfloat16, 64)])
def test_frustum_kernels_match_plain_at_a_rolled_pose(dev, dtype, c):
    """The rolled pose, the -2 sentinel among the zi: both kernels bit for
    bit, each launched once."""
    vol, zi, x, y, z, dint = _frustum_inputs(dev, c, 32, dtype, rolled=True)
    assert (zi == -2).any()
    before = (plane_warp_exact_z.KERNEL.launches, plane_mix.KERNEL.launches)
    got = plane_warp_exact_z.exact_z_resample(vol, zi, x, y, z, 0.5, dint)
    mixed = plane_mix.plane_mix_resample(vol, zi, x, y)
    assert (plane_warp_exact_z.KERNEL.launches,
            plane_mix.KERNEL.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, resample_exact_z(vol, zi, x, y, z, 0.5, dint))
    assert torch.equal(mixed,
                       plane_mix.plane_mix_resample_plain(vol, zi, x, y))


def _attention_inputs(dev, b=2, n=3, d=4, h=6, w=8, c=16):
    gen = torch.Generator().manual_seed(3)
    warped = torch.randn(b, n, d, h, w, 2 * c, generator=gen).to(dev)
    tk = torch.randn(b, 2, d, h, w, c, generator=gen).to(dev)[:, 1]
    view = warped.transpose(0, 1)
    return tk, view[..., :c], view[..., c:]


@pytest.mark.parametrize("valid", [
    [[True, True], [True, True], [True, True]],
    [[True, False], [False, False], [True, False]],  # batch 1: none valid
    [[True, True], [False, True], [False, False]]])
def test_attention_kernel_matches_plain(dev, valid):
    """On the strided views the fusion hands over (K and V halves of one
    warped volume; a target key sliced out of a wider tensor)."""
    tk, wk, wv = _attention_inputs(dev)
    valid = torch.tensor(valid, device=dev).t().contiguous().t()  # [N, B]
    before = epipolar_attention.KERNEL.launches
    got = epipolar_attention.epipolar_attention(tk, wk, wv, valid)
    assert epipolar_attention.KERNEL.launches == before + 1
    want = epipolar_attention.epipolar_attention_plain(tk, wk, wv, valid)
    assert got.is_contiguous() and got.shape == tk.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for b in range(valid.shape[1]):
        if not valid[:, b].any():
            assert got[b].abs().max().item() == 0.0


def test_new_kernels_refuse_what_they_cannot_take(dev):
    """bfloat16 inputs launch the bf16 instances since the bf16 model;
    float16 and mixed dtypes raise, as do shapes the kernels cannot
    take."""
    vol = torch.zeros(1, 4, 6, 8, 8, device=dev)
    coords = torch.zeros(1, 4 * 6 * 8, device=dev)
    zi = torch.zeros(1, 4, 48, device=dev)
    assert plane_mix.plane_mix_resample(vol.bfloat16(), zi, coords,
                                        coords).dtype == torch.bfloat16
    with pytest.raises(TypeError):
        plane_mix.plane_mix_resample(vol.half(), zi, coords, coords)
    with pytest.raises(ValueError):  # C % 4
        plane_mix.plane_mix_resample(vol[..., :6].contiguous(), zi, coords,
                                     coords)
    with pytest.raises(ValueError, match="contiguous"):
        plane_mix.plane_mix_resample(vol[..., :4], zi, coords, coords)

    tk, wk, wv = _attention_inputs(dev)
    valid = torch.ones(3, 2, dtype=torch.bool, device=dev)
    assert epipolar_attention.epipolar_attention(
        tk.bfloat16(), wk.bfloat16(), wv.bfloat16(),
        valid).dtype == torch.bfloat16
    with pytest.raises(TypeError):  # keys and values in the key's dtype
        epipolar_attention.epipolar_attention(tk.bfloat16(), wk, wv, valid)
    with pytest.raises(TypeError):
        epipolar_attention.epipolar_attention(tk.half(), wk.half(),
                                              wv.half(), valid)
    with pytest.raises(ValueError, match="C == 16"):
        epipolar_attention.epipolar_attention(
            tk[..., :8], wk[..., :8], wv[..., :8], valid)
    with pytest.raises(ValueError, match="1 <= N <= 8"):
        epipolar_attention.epipolar_attention(
            tk, wk.repeat(3, 1, 1, 1, 1, 1), wv.repeat(3, 1, 1, 1, 1, 1),
            valid.repeat(3, 1))
    swapped = torch.zeros(2, 4, 6, 16, 8, device=dev).transpose(-1, -2)
    with pytest.raises(ValueError, match="channel stride"):
        epipolar_attention.epipolar_attention(swapped, wk, wv, valid)
    with pytest.raises(ValueError, match="differ"):
        epipolar_attention.epipolar_attention(tk, wk, wv.contiguous(), valid)


def _two_pass_inputs(dev, planes_per_map, m=2, h=24, w=32, c=8):
    """Near-identity homographies with shifts, shear and perspective."""
    rng = np.random.default_rng(5)
    p = m * planes_per_map
    hm = np.tile(np.eye(3, dtype=np.float32), (p, 1, 1))
    hm += rng.normal(size=(p, 3, 3)).astype(np.float32) * [
        [0.08, 0.08, 3.0], [0.08, 0.08, 2.0], [1e-3, 1e-3, 0.02]]
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([u.ravel(), v.ravel(), np.ones(h * w)]).astype(np.float32)
    q = hm.astype(np.float32) @ pix
    src = torch.from_numpy(rng.normal(size=(m, h, w, c)).astype(np.float32))
    hm = torch.from_numpy(hm.astype(np.float32)).to(dev)
    x = torch.from_numpy((q[:, 0] / q[:, 2]).astype(np.float32)).to(dev)
    y = torch.from_numpy((q[:, 1] / q[:, 2]).astype(np.float32)).to(dev)
    return src.to(dev), two_pass.line_coeffs(hm, w), x, y


@pytest.mark.parametrize("planes_per_map,c,w", [
    (1, 8, 32), (6, 8, 32), (6, 4, 32), (6, 32, 32), (6, 64, 32),
    (3, 8, 33), (2, 12, 31)])
def test_two_pass_kernel_matches_plain(dev, planes_per_map, c, w):
    """Bit for bit, with a map per plane and maps shared by planes, at
    each channel count the kernel has an instance for, an odd width, and a
    C / 4 it takes through its generic instance."""
    src, ab, x, y = _two_pass_inputs(dev, planes_per_map, w=w, c=c)
    before = two_pass.KERNEL.launches
    got = two_pass.two_pass_resample(src, ab, x, y, planes_per_map)
    assert two_pass.KERNEL.launches == before + 1
    assert torch.equal(got, two_pass.two_pass_resample_plain(
        src, ab, x, y, planes_per_map))
    assert (got == 0).any() and (got != 0).any()


def test_two_pass_kernel_takes_a_large_image(dev):
    """A 128x160 image, whose [H, W, 4] pass-1 image (320 KB) would not
    fit in a block's shared memory: the kernel keeps none, launches and
    equals the plain version."""
    src, ab, x, y = _two_pass_inputs(dev, 2, m=1, h=128, w=160, c=4)
    before = two_pass.KERNEL.launches
    got = two_pass.two_pass_resample(src, ab, x, y, 2)
    assert two_pass.KERNEL.launches == before + 1
    assert got.shape == (2, 128, 160, 4)
    assert torch.equal(got, two_pass.two_pass_resample_plain(src, ab, x, y,
                                                             2))
    assert (got != 0).any()


def _grad_pair(kernel_fn, plain_fn, volume, coords, seed):
    """(gradient through the wrapper on the card, autograd of the plain
    version) for one random cotangent; the coordinates require grad too and
    must get none from the wrapper."""
    gen = torch.Generator().manual_seed(seed)
    vol = volume.clone().requires_grad_()
    cs = [c.clone().requires_grad_() for c in coords]
    out = kernel_fn(vol, *cs)
    ct = torch.randn(out.shape, generator=gen).to(out.device)
    out.backward(ct)
    assert all(c.grad is None for c in cs)
    ref = volume.clone().requires_grad_()
    (want,) = torch.autograd.grad(plain_fn(ref, *coords), ref, ct)
    return vol.grad, want


def _grad_close(got, want):
    scale = want.abs().max().item()
    assert scale > 0
    assert (got - want).abs().max().item() <= 3e-5 * scale


def test_warp_kernels_have_the_plain_versions_gradients(dev):
    b, h, w, d, c = 2, 24, 32, 16, 8
    k, poses, dv = _setup(dev, h, w, d, c, b)
    gen = torch.Generator().manual_seed(4)
    dint = (8.0 - 0.5) / (d - 1)
    # kernel 1
    src = torch.randn(b, h, w, c, generator=gen).to(dev)
    proj = geometry.camera_projection(k, poses)
    ref = geometry.camera_projection(k, torch.eye(4, device=dev).expand(
        b, 4, 4))
    x, y = warp.plane_sweep_coords(proj, ref, dv, h, w)
    counts = [kern.launches for kern in (
        plane_warp.KERNEL, plane_warp_exact_z.KERNEL, plane_mix.KERNEL,
        two_pass.KERNEL)]
    _grad_close(*_grad_pair(plane_warp.plane_sweep_sample,
                            plane_warp.plane_sweep_sample_plain, src, (x, y),
                            0))
    # kernels 2 and 4
    vol = torch.randn(b, d, h, w, c, generator=gen).to(dev)
    t, grid, x, y, z = warp.frustum_coords(poses, k, dv, h, w)
    zi = zi_field(t, k, dv, 0.5, dint, grid)
    _grad_close(*_grad_pair(
        lambda v, *cs: plane_warp_exact_z.exact_z_resample(v, *cs, 0.5, dint),
        lambda v, *cs: resample_exact_z(v, *cs, 0.5, dint), vol,
        (zi, x, y, z), 1))
    _grad_close(*_grad_pair(plane_mix.plane_mix_resample,
                            plane_mix.plane_mix_resample_plain, vol,
                            (zi, x, y), 2))
    # kernel 3: the gradient of the exact bilinear sample at (x, y)
    src, ab, x, y = _two_pass_inputs(dev, 6)
    _grad_close(*_grad_pair(
        lambda s, a, xs, ys: two_pass.two_pass_resample(s, a, xs, ys, 6),
        lambda s, a, xs, ys: plane_warp.plane_sweep_sample_plain(
            s, xs.reshape(2, -1), ys.reshape(2, -1)).reshape(-1, 24, 32, 8),
        src, (ab, x, y), 3))
    # every forward launched its kernel
    assert [kern.launches for kern in (
        plane_warp.KERNEL, plane_warp_exact_z.KERNEL, plane_mix.KERNEL,
        two_pass.KERNEL)] == [n + 1 for n in counts]


def test_attention_kernel_refuses_a_gradient(dev):
    tk, wk, wv = _attention_inputs(dev)
    valid = torch.ones(3, 2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="requires grad"):
        epipolar_attention.epipolar_attention(
            tk.clone().requires_grad_(), wk, wv, valid)
    with pytest.raises(ValueError, match="requires grad"):
        epipolar_attention.epipolar_attention(
            tk, wk.clone().requires_grad_(), wv, valid)


def test_train_step_launches_the_kernels_and_remat_relaunches_them(dev):
    """A small training step on the card: one plane sweep and one exact-z
    frustum warp per target in the forward, their gradients through the
    plain versions; with remat the recomputed forward launches each again,
    and the loss and the gradient norm are the plain step's."""
    from estdepth_tpu_torch.config import ModelConfig
    from estdepth_tpu_torch.data.synthetic import (
        SyntheticSceneConfig, synthetic_window,
    )
    from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
    from estdepth_tpu_torch.train.trainer import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    window = synthetic_window(SyntheticSceneConfig(height=64, width=96,
                                                   focal=80.0), n_frames=4,
                              depth_min=0.5, depth_max=8.0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in window.items()}
    results = {}
    for remat in (False, True):
        model = DepthNetHybrid(ModelConfig(
            ndepths=8, depth_min=0.5, depth_max=8.0, resnet=18), seed=0)
        model.to(dev)
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
        step = make_train_step(model, opt, sched, 0.5, 8.0, remat=remat,
                               remat_policy="save_features")
        before = (plane_warp.KERNEL.launches,
                  plane_warp_exact_z.KERNEL.launches)
        scalars = step(batch, 10.0)
        launched = (plane_warp.KERNEL.launches - before[0],
                    plane_warp_exact_z.KERNEL.launches - before[1])
        assert launched == ((2, 4) if remat else (1, 2))
        results[remat] = (float(scalars["loss"]),
                          float(scalars["grad_norm"]),
                          int(model.pre0[1].num_batches_tracked))
    assert results[True][2] == results[False][2] == 1
    np.testing.assert_allclose(results[True][:2], results[False][:2],
                               rtol=1e-4)


def test_dataset_eval_on_the_card_matches_cpu(dev, tmp_path):
    """The ESTM tool's dataset path at a small size (a ScanNet-layout scene
    written by data/png.py, a reference checkpoint, maps saved): the
    card's maps within the chain tolerance 8e-3 of the CPU run's, and
    depth_metrics on the card equal to it on the CPU."""
    from estdepth_tpu_torch.config import ModelConfig
    from estdepth_tpu_torch.data.synthetic import (
        SyntheticSceneConfig, pose, write_scannet_scene,
    )
    from estdepth_tpu_torch.eval.metrics import depth_metrics
    from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
    from estdepth_tpu_torch.tools import eval_estm

    torch.backends.cudnn.allow_tf32 = False
    cfg = SyntheticSceneConfig(height=120, width=160, focal=144.4675)
    poses = []  # a small pitch and lift: no coordinate on the border
    for i in range(7):
        p = pose(cfg, i) @ _pose(0.0, 0.011 * i, 0.0, 0.0,
                                 0.013 * i + 0.002).numpy()
        poses.append(p)
    write_scannet_scene(str(tmp_path / "data" / "scene0000_00"), cfg, poses)
    model = DepthNetHybrid(ModelConfig(ndepths=8, depth_min=0.5,
                                       depth_max=8.0, resnet=18), seed=0)
    ckpt = str(tmp_path / "model.ckpt")
    torch.save({"model": {f"module.{k}": v
                          for k, v in model.state_dict().items()}}, ckpt)
    argv = ["--datapath", str(tmp_path / "data"), "--ckpt", ckpt,
            "--height", "64", "--width", "96", "--ndepths", "8", "--resnet",
            "18", "--frame-interval", "1", "--depth-min", "0.5",
            "--depth-max", "8.0", "--save-maps"]
    maps = {}
    for name, d in (("cpu", "cpu"), ("card", str(dev))):
        res = eval_estm.run(eval_estm.parse_args(
            argv + ["--device", d, "--outdir", str(tmp_path / name)]),
            keep_maps=True)
        maps[name] = np.stack(res["maps"])
    assert maps["card"].shape == (5, 2, 64, 96)
    np.testing.assert_allclose(maps["card"], maps["cpu"], atol=8e-3, rtol=0)

    rng = np.random.default_rng(0)
    pred = torch.from_numpy(maps["cpu"][None])  # [1, T, 2, H, W]
    gt = torch.from_numpy(rng.uniform(0.5, 5.0, (1, 5, 64, 96)).astype(
        np.float32))
    mask = gt > 1.0
    want = depth_metrics(pred, gt, mask, scales=(0, 1))
    got = depth_metrics(pred.to(dev), gt.to(dev), mask.to(dev),
                        scales=(0, 1))
    for k, v in want.items():
        assert got[k].device.type == dev.type
        np.testing.assert_allclose(got[k].cpu().numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_cpu_exported_artifact_launches_the_kernels_on_the_card(dev,
                                                               tmp_path):
    """A stream artifact exported on the CPU and loaded onto the card: its
    op nodes launch kernels 1 and 2 there (one sweep per window, one
    frustum warp per EST window), never the plain version, and its maps
    equal a card ESTMRunner's within 1e-5."""
    from estdepth_tpu_torch import serving
    from estdepth_tpu_torch.config import ModelConfig
    from estdepth_tpu_torch.data.synthetic import (
        SyntheticSceneConfig, synthetic_stream,
    )
    from estdepth_tpu_torch.eval.estm import ESTMRunner
    from estdepth_tpu_torch.models.estdepth import DepthNetHybrid

    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(ndepths=8, depth_min=0.5, depth_max=8.0, resnet=18)
    serving.export_stream(DepthNetHybrid(cfg, seed=0), height=64, width=96,
                          output_scales=(0, 2), device="cpu").save(
        str(tmp_path))
    runner = serving.load_stream(str(tmp_path), device=dev)
    live = ESTMRunner(DepthNetHybrid(cfg, seed=0), 64, 96,
                      output_scales=(0, 2), device=dev)
    frames = list(synthetic_stream(SyntheticSceneConfig(
        height=64, width=96, focal=80.0), 6, 0.5, 8.0))
    kernels = (plane_warp.KERNEL, plane_warp_exact_z.KERNEL)
    before = [k.launches for k in kernels]
    got = [out for f in frames if (out := runner.push_frame(
        f["img"], f["cam_pose"], f["cam_intr"])) is not None]
    assert [k.launches - n for k, n in zip(kernels, before)] == [4, 3]
    want = [out for f in frames if (out := live.push_frame(
        f["img"], f["cam_pose"], f["cam_intr"])) is not None]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# ---- the bf16 instances (the bf16 model's kernels) ----------------------
#
# A bf16 instance reads bf16 rows, computes the float32 instance's
# operations and rounds once (csrc/vec16.cuh); the plain bf16 version
# upcasts, runs the float32 plain version and casts once. Kernels 1-4 are
# therefore their plain versions bit for bit in bf16 too, and the
# attention kernel, whose float32 sums run in another order, lies within
# one bf16 ulp (at the output's scale) of its plain version.


def _within_one_bf16_ulp(got, want):
    """Within one bf16 ulp at the output's scale: the two float32 sums
    differ in their last bits, and where a value cancels to near zero
    that is more than the value's own ulp."""
    assert got.dtype == want.dtype == torch.bfloat16
    scale = want.float().abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert (got.float() - want.float()).abs().max().item() <= ulp


@pytest.mark.parametrize("c,w", [(8, 32), (16, 32), (32, 32), (64, 32),
                                 (8, 33), (24, 31)])
def test_plane_sweep_bf16_instance_matches_plain(dev, c, w):
    """Bit for bit, at each channel count the bf16 instance has a
    compile-time vector count for, an odd width, and a C / 8 it takes
    through its generic instance."""
    b, h, d = 2, 24, 16
    k, poses, dv = _setup(dev, h, w, d, c, b)
    src = torch.randn(b, h, w, c, generator=torch.Generator().manual_seed(0))
    src = src.to(dev).bfloat16()
    proj = geometry.camera_projection(k, poses)
    ref = geometry.camera_projection(k, torch.eye(4, device=dev).expand(
        b, 4, 4))
    x, y = warp.plane_sweep_coords(proj, ref, dv, h, w)
    before = plane_warp.KERNEL.launches_bf16
    got = plane_warp.plane_sweep_sample(src, x, y)
    assert plane_warp.KERNEL.launches_bf16 == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, plane_warp.plane_sweep_sample_plain(src, x, y))
    assert (got == 0).any() and (got != 0).any()


@pytest.mark.parametrize("planes_per_map,c", [(1, 8), (6, 32), (2, 24)])
def test_two_pass_bf16_instance_matches_plain(dev, planes_per_map, c):
    src, ab, x, y = _two_pass_inputs(dev, planes_per_map, c=c)
    src = src.bfloat16()
    before = two_pass.KERNEL.launches_bf16
    got = two_pass.two_pass_resample(src, ab, x, y, planes_per_map)
    assert two_pass.KERNEL.launches_bf16 == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, two_pass.two_pass_resample_plain(
        src, ab, x, y, planes_per_map))


@pytest.mark.parametrize("c,w", [(8, 32), (32, 32), (64, 32), (16, 33),
                                 (24, 31)])
def test_frustum_bf16_instances_match_plain(dev, c, w):
    """Kernels 2 and 4 in bf16: bit for bit (A and s float32 inside), at
    the multiples of 8 of the float32 tests, odd widths and a C / 8 the
    generic instance takes."""
    vol, zi, x, y, z, dint = _frustum_inputs(dev, c, w, torch.bfloat16)
    counts = (plane_warp_exact_z.KERNEL.launches_bf16,
              plane_mix.KERNEL.launches_bf16)
    got = plane_warp_exact_z.exact_z_resample(vol, zi, x, y, z, 0.5, dint)
    mixed = plane_mix.plane_mix_resample(vol, zi, x, y)
    assert (plane_warp_exact_z.KERNEL.launches_bf16,
            plane_mix.KERNEL.launches_bf16) == (counts[0] + 1, counts[1] + 1)
    assert got.dtype == mixed.dtype == torch.bfloat16
    assert torch.equal(got, resample_exact_z(vol, zi, x, y, z, 0.5, dint))
    assert torch.equal(mixed, plane_mix.plane_mix_resample_plain(vol, zi, x,
                                                                 y))


@pytest.mark.parametrize("valid", [
    [[True, True], [True, True], [True, True]],
    [[True, False], [False, False], [True, False]]])
def test_attention_bf16_instance_within_one_ulp(dev, valid):
    tk, wk, wv = (t.bfloat16() for t in _attention_inputs(dev))
    valid = torch.tensor(valid, device=dev).t().contiguous().t()
    before = epipolar_attention.KERNEL.launches_bf16
    got = epipolar_attention.epipolar_attention(tk, wk, wv, valid)
    assert epipolar_attention.KERNEL.launches_bf16 == before + 1
    _within_one_bf16_ulp(got, epipolar_attention.epipolar_attention_plain(
        tk, wk, wv, valid))


def test_bf16_stream_on_the_card_matches_cpu(dev):
    """A small bf16 ESTM stream through the bf16 instances against the
    same model on the CPU: within 2x the card's own bf16-against-float32
    distance on the same frames (bf16 rounds differently on the two
    devices' convolutions)."""
    from estdepth_tpu_torch.config import ModelConfig, torch_dtype
    from estdepth_tpu_torch.data.synthetic import (
        SyntheticSceneConfig, synthetic_stream,
    )
    from estdepth_tpu_torch.eval.estm import ESTMRunner
    from estdepth_tpu_torch.models.estdepth import DepthNetHybrid

    torch.backends.cudnn.allow_tf32 = False
    frames = list(synthetic_stream(SyntheticSceneConfig(
        height=64, width=96, focal=80.0), 6, 0.5, 8.0))
    outs = {}
    for dtype, device in (("float32", dev), ("bfloat16", dev),
                          ("bfloat16", "cpu")):
        cfg = ModelConfig(ndepths=8, depth_min=0.5, depth_max=8.0, resnet=18,
                          compute_dtype=dtype)
        runner = ESTMRunner(DepthNetHybrid(cfg, seed=0), 64, 96,
                            device=device)
        before = plane_warp_exact_z.KERNEL.launches_bf16
        outs[dtype, str(device)] = [
            out.cpu() for f in frames if (out := runner.push_frame(
                f["img"], f["cam_pose"], f["cam_intr"])) is not None]
        assert runner.memory.keys.dtype == torch_dtype(dtype)
        if dtype == "bfloat16" and device == dev:
            assert plane_warp_exact_z.KERNEL.launches_bf16 == before + 3

    def dist(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b))

    own = dist(outs["bfloat16", str(dev)], outs["float32", str(dev)])
    assert dist(outs["bfloat16", str(dev)], outs["bfloat16", "cpu"]) <= (
        2 * own)


def test_one_nccl_rank_matches_the_one_device_step(dev, tmp_path):
    """tools/train.py --multihost on one NCCL rank (a data mesh of one
    process: DDP, synced BatchNorm, the scalars' all-reduce) against the
    tool's one-device run from the same weights and windows: the losses of
    3 steps at rtol 3e-3, the BatchNorm statistics at rtol 5e-3 (atol
    5e-4), the PARITY.md trajectory tolerances, and the same kernel
    launches. The ranks' own tests over gloo on the CPU are
    tests/test_torch_port_parallel.py (it imports JAX, which the card's
    machine lacks)."""
    import socket

    from estdepth_tpu_torch.tools import train

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    flags = ["--synthetic", "--steps", "3", "--height", "64", "--width",
             "96", "--ndepths", "8", "--depth-min", "0.5", "--depth-max",
             "8.0", "--resnet", "18", "--n-frames", "4", "--summary-freq",
             "1", "--seed", "0", "--num-workers", "1"]
    kernels = (plane_warp.KERNEL, plane_warp_exact_z.KERNEL)
    runs = {}
    for name, extra in (("one", []), ("nccl", [
            "--multihost", "--coordinator", f"localhost:{port}",
            "--num-processes", "1", "--process-id", "0"])):
        before = [k.launches for k in kernels]
        res = train.run(train.parse_args(
            flags + ["--logdir", str(tmp_path / name)] + extra))
        runs[name] = ([r["loss"] for r in res["records"]],
                      {k: v.cpu() for k, v in
                       res["state"].model.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))},
                      [k.launches - b for k, b in zip(kernels, before)])
    assert not torch.distributed.is_initialized()
    np.testing.assert_allclose(runs["nccl"][0], runs["one"][0], rtol=3e-3)
    for k, want in runs["one"][1].items():
        np.testing.assert_allclose(runs["nccl"][1][k].numpy(), want.numpy(),
                                   rtol=5e-3, atol=5e-4, err_msg=k)
    assert runs["nccl"][2] == runs["one"][2] == [3, 6]


def test_senet_stream_on_the_card_matches_cpu(dev):
    """A small ESTM stream of the SENet model (SEFeatureNet as the matching
    encoder) through the kernels on the card against the same model on
    the CPU: all 4 scales within the chain tolerance 8e-3, and the
    kernels launched once per window (the sweep) and once per EST window
    (the exact-z warp)."""
    from estdepth_tpu_torch.config import ModelConfig
    from estdepth_tpu_torch.data.synthetic import (
        SyntheticSceneConfig, synthetic_stream,
    )
    from estdepth_tpu_torch.eval.estm import ESTMRunner
    from estdepth_tpu_torch.models.estdepth import DepthNetHybrid

    torch.backends.cudnn.allow_tf32 = False
    frames = list(synthetic_stream(SyntheticSceneConfig(
        height=64, width=96, focal=80.0), 6, 0.5, 8.0))
    for i, f in enumerate(frames):  # no coordinate on the border
        f["cam_pose"] = f["cam_pose"] @ _pose(
            0.0, 0.011 * i, 0.0, 0.0, 0.013 * i + 0.002).numpy()
    cfg = ModelConfig(ndepths=8, depth_min=0.5, depth_max=8.0, resnet=18,
                      feature_net="senet")
    outs = {}
    for device in ("cpu", dev):
        runner = ESTMRunner(DepthNetHybrid(cfg, seed=0), 64, 96,
                            device=device)
        sweeps = plane_warp.KERNEL.launches
        warps = plane_warp_exact_z.KERNEL.launches
        outs[str(device)] = [
            out.cpu() for f in frames if (out := runner.push_frame(
                f["img"], f["cam_pose"], f["cam_intr"])) is not None]
    assert plane_warp.KERNEL.launches == sweeps + 4
    assert plane_warp_exact_z.KERNEL.launches == warps + 3
    err = max((a - b).abs().max().item()
              for a, b in zip(outs["cpu"], outs[str(dev)]))
    assert len(outs[str(dev)]) == 4 and err < 8e-3, err


def test_scene_batch_on_the_card_equals_one_scene_at_a_time(dev, tmp_path):
    """Both eval tools at --scan --scene-batch 2 over three ScanNet-layout
    scenes of 9, 12 and 7 frames (a group of two and a partial group of
    one) against --scene-batch 1 on the card: within 1e-3 (cuDNN may pick
    another algorithm at another batch)."""
    from estdepth_tpu_torch.data.synthetic import (
        SyntheticSceneConfig, pose, write_scannet_scene,
    )
    from estdepth_tpu_torch.tools import eval_estm, eval_joint

    torch.backends.cudnn.allow_tf32 = False
    for seed, n in enumerate((9, 12, 7)):
        cfg = SyntheticSceneConfig(height=96, width=128, focal=115.574,
                                   seed=seed)
        write_scannet_scene(
            str(tmp_path / f"scene{seed:04d}_00"), cfg,
            [pose(cfg, i) @ _pose(0.0, 0.011 * i, 0.0, 0.0,
                                  0.013 * i + 0.002).numpy()
             for i in range(n)])
    argv = ["--datapath", str(tmp_path), "--height", "64", "--width", "96",
            "--ndepths", "8", "--resnet", "18", "--frame-interval", "1",
            "--depth-min", "0.5", "--depth-max", "8.0", "--scan",
            "--device", str(dev)]
    for tool, n in ((eval_estm, 7 + 10 + 5), (eval_joint, 2 + 3 + 1)):
        maps = [np.stack(tool.run(tool.parse_args(
            argv + ["--scene-batch", b]), keep_maps=True)["maps"])
            for b in ("1", "2")]
        assert len(maps[0]) == len(maps[1]) == n
        np.testing.assert_allclose(maps[1], maps[0], atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_an_output_window_are_the_whole_columns(dev, dtype):
    """Kernels 1, 2 and 4 given a width shard's coordinates [B, D, H, Wo]
    (parallel/spatial.py): `torch.equal` to the whole launch's columns and
    to the plain version at the window, both instances."""
    c, w = 32, 32
    vol, zi, x, y, z, dint = _frustum_inputs(dev, c, w, dtype, rolled=True)
    b, d, h = vol.shape[:3]
    src = vol[:, 0].contiguous()
    whole = {"sweep": plane_warp.plane_sweep_sample(src, x, y),
             "exact_z": plane_warp_exact_z.exact_z_resample(
                 vol, zi, x, y, z, 0.5, dint),
             "plane_mix": plane_mix.plane_mix_resample(vol, zi, x, y)}
    for lo, hi in ((0, 16), (16, 32), (5, 22)):
        xs, ys, zs = (q.reshape(b, d, h, w)[..., lo:hi].contiguous()
                      for q in (x, y, z))
        before = [k.KERNEL.launches for k in (plane_warp, plane_warp_exact_z,
                                              plane_mix)]
        got = {"sweep": plane_warp.plane_sweep_sample(src, xs, ys),
               "exact_z": plane_warp_exact_z.exact_z_resample(
                   vol, zi, xs, ys, zs, 0.5, dint),
               "plane_mix": plane_mix.plane_mix_resample(vol, zi, xs, ys)}
        assert [k.KERNEL.launches for k in (
            plane_warp, plane_warp_exact_z, plane_mix)] == [
            n + 1 for n in before]
        plain = {"sweep": plane_warp.plane_sweep_sample_plain(src, xs, ys),
                 "exact_z": resample_exact_z(vol, zi, xs, ys, zs, 0.5, dint),
                 "plane_mix": plane_mix.plane_mix_resample_plain(
                     vol, zi, xs, ys)}
        for name, out in got.items():
            assert out.shape == (b, d, h, hi - lo, c), name
            assert torch.equal(out, whole[name][:, :, :, lo:hi]), name
            assert torch.equal(out, plain[name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_pass_kernel_at_an_output_window_is_the_whole_columns(dev,
                                                                  dtype):
    """Kernel 3 given a width shard's line coefficients [P, 2, Wo] and
    coordinates [P, H*Wo] (parallel/spatial.py): `torch.equal` to the
    whole launch's columns and to the plain version at the window, both
    instances, at windows of one column, a ragged middle and both
    halves."""
    ppm, m, h, w, c = 6, 2, 24, 32, 16
    src, ab, x, y = _two_pass_inputs(dev, ppm, m=m, h=h, w=w, c=c)
    src = src.to(dtype)
    p = m * ppm
    whole = two_pass.two_pass_resample(src, ab, x, y, ppm)
    assert (whole == 0).any() and (whole != 0).any()
    for lo, hi in ((0, 16), (16, 32), (5, 22), (31, 32)):
        ab_w = ab[..., lo:hi].contiguous()
        xs, ys = (q.reshape(p, h, w)[..., lo:hi].reshape(p, -1).contiguous()
                  for q in (x, y))
        before = two_pass.KERNEL.launches
        got = two_pass.two_pass_resample(src, ab_w, xs, ys, ppm)
        assert two_pass.KERNEL.launches == before + 1
        assert got.shape == (p, h, hi - lo, c) and got.dtype == dtype
        assert torch.equal(got, whole[:, :, lo:hi]), (lo, hi)
        assert torch.equal(got, two_pass.two_pass_resample_plain(
            src, ab_w, xs, ys, ppm)), (lo, hi)


def test_matching_encoder_under_measured_plans_is_float32(dev):
    """The PSM encoder of `DepthNetHybrid._matching` at the Joint window's
    [5, 3, 256, 320] float32 after `set_fp32_numerics()`, through its
    measured-plan scope: cuDNN's benchmark flag on and TF32 off inside
    the call, every flag as it was after, no TF32 kernel among those the
    call (the plan search included) launches, and the features within
    1e-4 of their scale of the same weights and frames on the CPU (a plan
    once chosen for a shape is kept by the process, so the CPU, not an
    unscoped card run, is the reference)."""
    from estdepth_tpu_torch.config import ModelConfig, set_fp32_numerics
    from estdepth_tpu_torch.models.estdepth import DepthNetHybrid

    set_fp32_numerics()
    before = (torch.backends.cudnn.benchmark, torch.backends.cudnn.enabled,
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark_limit)
    model = DepthNetHybrid(ModelConfig(ndepths=8, resnet=18), seed=0)
    imgs = torch.rand(5, 256, 320, 3,
                      generator=torch.Generator().manual_seed(0)) * 255
    with torch.no_grad():
        want = model.compute_matching(imgs)
    model.to(dev)
    inside = []
    hook = model.matchingFeature.register_forward_pre_hook(
        lambda mod, args: inside.append((torch.backends.cudnn.benchmark,
                                         torch.backends.cudnn.allow_tf32)))
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof, \
                torch.no_grad():
            got = model.compute_matching(imgs.to(dev))
            torch.cuda.synchronize()
    finally:
        hook.remove()
    assert inside == [(True, False)]
    assert (torch.backends.cudnn.benchmark, torch.backends.cudnn.enabled,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark_limit) == before
    assert not torch.backends.cudnn.allow_tf32
    kernels = {e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert kernels and not [k for k in kernels if "tf32" in k.lower()]
    gap = float((got.cpu() - want).abs().max())
    assert gap <= 1e-4 * float(want.abs().max()), gap
