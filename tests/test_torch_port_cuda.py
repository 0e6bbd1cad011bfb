"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips where no CUDA device is present (decided in
the fixture, not at import). On a machine with the card:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest

The four warp kernels repeat their plain version's arithmetic operation
by operation (no FMA contraction) and are held to it bit for bit
(`torch.equal`), in both instances; chip_smoke.py holds them so at the
flagship shapes too, where it times them for PERF.md's table of kernels.
Their gradients on the card are autograd of the plain versions, held to
autograd of the plain version called directly at 3e-5 of the gradient's
scale (both scatter-add with float atomics, in an order that changes from
run to run; up to 5.3e-6 at the flagship shapes).
The attention kernel sums its 16 channels and its softmax in another order
than PyTorch's reductions, so it is held to rtol 1e-5 / atol 1e-6, the
tolerance the JAX package holds its TPU kernel to (tests/test_pallas.py).
The ESTM tool's dataset path (a scene written by data/png.py, a reference
checkpoint) is held against its CPU run at the chain tolerance 8e-3. A
serving artifact exported on the CPU and loaded onto the card launches
the kernels from its op nodes and equals a card ESTMRunner within 1e-5.
Kernel 1 is also held so at CasMVSNet's per-pixel depth hypotheses, and
the port's own variance kernel (CasMVSNet's cost volume, no TPU
counterpart) at the three DTU stages' shapes on real sweeps, at odd
widths and 1 to 16 source views, and inside the model's stage-2 cost
volume. The correlation kernel (TransMVSNet's cost volume, no TPU
counterpart) sums its channels in another order than ATen's, so it is
held to 4 C 2^-23 mean_c |warped_c ref_c| of its plain version at every
voxel, at the three DTU stages' shapes on real sweeps and at odd widths
and channel counts. TransMVSNet on the card follows its plain reference
on the CPU at the small size, and correlates each source view once a
stage. VGGT at the published widths with 4 + 4 blocks, under bf16
autocast on the card, lies closer to its float32 reference than the
reference cast wholly to bf16 does, and its attention op runs a fused
SDPA kernel.
The port's GroupNorm-and-activation kernel (the EST GRU's norms, no TPU
counterpart) sums in another order than ATen's group norm, so it is held
to 4 float32 ulps of the output's scale of its plain version (bf16: one
bf16 ulp) at the GRU's shapes, 3 targets at once and odd, misaligned
rows, to float64 statistics within 1e-6, and to its own output on a
second run; each grad-free GRU call of the stream and the Joint chain
launches it twice, a training step never.
The PSM matching encoder, under its measured cuDNN plans, stays float32
(no TF32 kernel) and within 1e-4 of its scale of the CPU's features.
Under `torch.cuda.set_sync_debug_mode("warn")` a steady request of each
runner (stream, Joint, training, CasMVSNet, TransMVSNet, VGGT) syncs the
host with the card only inside `utils/trace.host_wait` spans.

The paths at the small size (64x96, D = 8, ResNet-18): the ESTM stream,
the Joint chain in both frustum modes, the training step through the
two-pass sweep, each in float32 and bf16, launch exactly their kernels
(a bf16 run only bf16 instances), and between them all five in each
dtype. Small chains on the card against the same model on the CPU: the
stream (float32 at 8e-3; bf16, also of the SENet model, within twice the
card's own bf16-against-float32 distance), the Joint chain in both modes
at 8e-3, 3 training steps through the two-pass sweep at the PARITY.md
trajectory tolerances, and one NCCL rank against one device in both
dtypes. Artifacts exported on the card (the Joint step with the plane-mix
warp and the attention kernel, the stream step with the two-pass sweep,
the bf16 stream step) launch their kernels from their op nodes and equal
the live runners within 1e-5 (bf16: the export tool's bound). The
full-width paths are the benchmark's cells (portbench/), whose runs check
their output against its plain reference, and, for the routes no cell
runs, chip_smoke.py's launch and range checks.
Without JAX on the card's machine, run with `--noconftest`.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import pytest
import torch

from estdepth_tpu_torch.ops import geometry, warp
from estdepth_tpu_torch.ops.cuda import (
    epipolar_attention, group_norm_act, plane_mix, plane_warp,
    plane_warp_exact_z, two_pass, view_correlation, view_variance,
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


def test_plane_sweep_kernel_at_per_pixel_hypotheses(dev):
    """Kernel 1 at the per-pixel coordinates of CasMVSNet's stage 2 at the
    DTU setting (576x800 maps of 16 channels, 32 hypotheses a pixel
    around a depth map, models/casmvsnet.py): `torch.equal` to the plain
    version, through plane_sweep_warp and through the op itself."""
    b, h, w, c, d = 1, 576, 800, 16, 32
    k = torch.tensor([[[1446.165, 0, (w - 1) / 2], [0, 1446.165, (h - 1) / 2],
                       [0, 0, 1]]], device=dev)
    gen = torch.Generator().manual_seed(0)
    src = torch.randn(b, h, w, c, generator=gen).to(dev)
    centre = 0.6 + 0.1 * torch.rand(b, h, w, generator=gen)
    hyp = (centre[:, None] + torch.linspace(-0.085, 0.085, d)[
        None, :, None, None]).to(dev)
    proj = geometry.camera_projection(
        k, _pose(0.06, -0.01, -0.009, 0.004, 0.002)[None].to(dev))
    ref = geometry.camera_projection(k, torch.eye(4, device=dev)[None])
    x, y = warp.plane_sweep_coords(proj, ref, hyp, h, w)
    plain = plane_warp.plane_sweep_sample_plain(src, x, y)
    before = plane_warp.KERNEL.launches
    got = warp.plane_sweep_warp(src, proj, ref, hyp)
    assert plane_warp.KERNEL.launches == before + 1
    assert torch.equal(got, plain)
    assert torch.equal(plane_warp.plane_sweep_sample(
        src, x.reshape(b, d, h, w), y.reshape(b, d, h, w)), plain)
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
    from estdepth_tpu_torch.data.synthetic import (
        SyntheticSceneConfig, synthetic_window,
    )
    from estdepth_tpu_torch.train.trainer import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    window = synthetic_window(SyntheticSceneConfig(height=64, width=96,
                                                   focal=80.0), n_frames=4,
                              depth_min=0.5, depth_max=8.0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in window.items()}
    results = {}
    for remat in (False, True):
        model = _small_model().to(dev)
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
        step = make_train_step(model, opt, sched, 0.5, 8.0, remat=remat,
                               remat_policy="save_features")
        before = _counts()
        scalars = step(batch, 10.0)
        _assert_launched(before, "float32", {
            "plane_sweep_warp": 2 if remat else 1,
            "frustum_warp_exact_z": 4 if remat else 2})
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
    from estdepth_tpu_torch.data.synthetic import (
        SyntheticSceneConfig, synthetic_stream,
    )

    torch.backends.cudnn.allow_tf32 = False
    serving.export_stream(_small_model(), height=64, width=96,
                          output_scales=(0, 2), device="cpu").save(
        str(tmp_path))
    runner = serving.load_stream(str(tmp_path), device=dev)
    frames = list(synthetic_stream(SyntheticSceneConfig(
        height=64, width=96, focal=80.0), 6, 0.5, 8.0))
    before = _counts()
    got = [out for f in frames if (out := runner.push_frame(
        f["img"], f["cam_pose"], f["cam_intr"])) is not None]
    _assert_launched(before, "float32", {"plane_sweep_warp": 4,
                                         "frustum_warp_exact_z": 3})
    want = [out[:, [0, 2]] for out in _stream(_small_model(), frames, dev)]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)


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


def _bf16_stream_against_cpu(dev, frames, **options):
    """A small bf16 ESTM stream through the bf16 instances against the
    same model on the CPU: within 2x the card's own bf16-against-float32
    distance on the same frames (bf16 rounds differently on the two
    devices' convolutions). `options` are further ModelConfig fields.
    On the card each stream launches one sweep a window step and one
    exact-z warp a step after the first, in its dtype's instances."""
    from estdepth_tpu_torch.config import torch_dtype
    from estdepth_tpu_torch.eval.estm import ESTMRunner

    torch.backends.cudnn.allow_tf32 = False
    steps = len(frames) - 2
    outs = {}
    for dtype, device in (("float32", dev), ("bfloat16", dev),
                          ("bfloat16", "cpu")):
        runner = ESTMRunner(_small_model(compute_dtype=dtype, **options), 64,
                            96, device=device)
        before = _counts()
        outs[dtype, str(device)] = [
            out.cpu() for f in frames if (out := runner.push_frame(
                f["img"], f["cam_pose"], f["cam_intr"])) is not None]
        assert runner.memory.keys.dtype == torch_dtype(dtype)
        if device == dev:
            _assert_launched(before, dtype, {
                "plane_sweep_warp": steps, "frustum_warp_exact_z": steps - 1})

    def dist(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b))

    own = dist(outs["bfloat16", str(dev)], outs["float32", str(dev)])
    assert dist(outs["bfloat16", str(dev)], outs["bfloat16", "cpu"]) <= (
        2 * own)


def test_bf16_stream_on_the_card_matches_cpu(dev):
    from estdepth_tpu_torch.data.synthetic import (
        SyntheticSceneConfig, synthetic_stream,
    )

    _bf16_stream_against_cpu(dev, list(synthetic_stream(SyntheticSceneConfig(
        height=64, width=96, focal=80.0), 6, 0.5, 8.0)))


def test_senet_bf16_stream_on_the_card_matches_cpu(dev):
    """The same for the SENet model (SEFeatureNet as the matching
    encoder), on the pitched frames."""
    _bf16_stream_against_cpu(dev, _pitched_frames(7), feature_net="senet")


def test_one_nccl_rank_matches_the_one_device_step(dev, tmp_path):
    """tools/train.py --multihost on one NCCL rank (a data mesh of one
    process: DDP, synced BatchNorm, the scalars' all-reduce) against the
    tool's one-device run from the same weights and windows: the losses of
    3 steps at rtol 3e-3, the BatchNorm statistics at rtol 5e-3 (atol
    5e-4), the PARITY.md trajectory tolerances, and the same kernel
    launches. The ranks' own tests over gloo on the CPU are
    tests/test_torch_port_parallel.py (it imports JAX, which the card's
    machine lacks)."""
    runs = {name: _train_tool_run(tmp_path / name, nccl)
            for name, nccl in (("one", False), ("nccl", True))}
    assert not torch.distributed.is_initialized()
    np.testing.assert_allclose(runs["nccl"][0], runs["one"][0], rtol=3e-3)
    for k, want in runs["one"][1].items():
        np.testing.assert_allclose(runs["nccl"][1][k].numpy(), want.numpy(),
                                   rtol=5e-3, atol=5e-4, err_msg=k)
    assert runs["nccl"][2] == runs["one"][2] == [3, 6]


def _train_tool_run(logdir, nccl: bool, bf16: bool = False):
    """3 steps of tools/train.py at the small size, on one device or (with
    `nccl`) as the one rank of a --multihost data mesh: (losses, BatchNorm
    running statistics, launches of kernels 1 and 2, of which bf16
    instances)."""
    import socket

    from estdepth_tpu_torch.tools import train

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    flags = ["--synthetic", "--steps", "3", "--height", "64", "--width",
             "96", "--ndepths", "8", "--depth-min", "0.5", "--depth-max",
             "8.0", "--resnet", "18", "--n-frames", "4", "--summary-freq",
             "1", "--seed", "0", "--num-workers", "1", "--logdir",
             str(logdir)]
    if nccl:
        flags += ["--multihost", "--coordinator", f"localhost:{port}",
                  "--num-processes", "1", "--process-id", "0"]
    if bf16:
        flags.append("--bf16")
    kernels = (plane_warp.KERNEL, plane_warp_exact_z.KERNEL)
    before = [(k.launches, k.launches_bf16) for k in kernels]
    res = train.run(train.parse_args(flags))
    return ([r["loss"] for r in res["records"]],
            {k: v.float().cpu() for k, v in
             res["state"].model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))},
            [k.launches - b[0] for k, b in zip(kernels, before)],
            [k.launches_bf16 - b[1] for k, b in zip(kernels, before)])


def test_one_nccl_rank_matches_the_one_device_step_in_bf16(dev, tmp_path):
    """The same in bf16 (`--bf16`): the losses at rtol 3e-3, the BatchNorm
    statistics within twice the one-device bf16 run's own largest distance
    from the float32 run's (the port's bf16 rule), and only bf16 instances
    launched."""
    f32 = _train_tool_run(tmp_path / "f32", nccl=False)
    one = _train_tool_run(tmp_path / "one", nccl=False, bf16=True)
    ddp = _train_tool_run(tmp_path / "nccl", nccl=True, bf16=True)
    assert not torch.distributed.is_initialized()
    np.testing.assert_allclose(ddp[0], one[0], rtol=3e-3)
    own = max(float((one[1][k] - v).abs().max()) for k, v in f32[1].items())
    worst = max(float((ddp[1][k] - v).abs().max()) for k, v in one[1].items())
    assert worst <= 2 * own, (worst, own)
    assert ddp[2] == ddp[3] == one[2] == one[3] == [3, 6]


def test_senet_stream_on_the_card_matches_cpu(dev):
    """A small ESTM stream of the SENet model (SEFeatureNet as the matching
    encoder) through the kernels on the card against the same model on
    the CPU: all 4 scales within the chain tolerance 8e-3, and the
    kernels launched once per window (the sweep) and once per EST window
    (the exact-z warp)."""
    torch.backends.cudnn.allow_tf32 = False
    frames = _pitched_frames(6)
    outs = {}
    for device in ("cpu", dev):
        before = _counts()
        outs[str(device)] = _stream(_small_model(feature_net="senet"), frames,
                                    device)
    _assert_launched(before, "float32", {"plane_sweep_warp": 4,
                                         "frustum_warp_exact_z": 3})
    err = max((a - b).abs().max().item()
              for a, b in zip(outs["cpu"], outs[str(dev)]))
    assert len(outs[str(dev)]) == 4 and err < 8e-3, err


def test_scene_batch_on_the_card_equals_one_scene_at_a_time(dev, tmp_path):
    """Both eval tools at --scan --scene-batch 2 over three ScanNet-layout
    scenes of 9, 12 and 7 frames (a group of two and a partial group of
    one) against --scene-batch 1 on the card: within 1e-3 (cuDNN may pick
    another algorithm at another batch)."""
    from estdepth_tpu_torch.tools import eval_estm, eval_joint

    argv = _scan_scenes(dev, tmp_path)
    for tool, n in ((eval_estm, 7 + 10 + 5), (eval_joint, 2 + 3 + 1)):
        maps = [np.stack(tool.run(tool.parse_args(
            argv + ["--scene-batch", b]), keep_maps=True)["maps"])
            for b in ("1", "2")]
        assert len(maps[0]) == len(maps[1]) == n
        np.testing.assert_allclose(maps[1], maps[0], atol=1e-3, rtol=0)


# ESTM window steps (lwindow 3) and Joint windows (5 frames advancing by
# 3) of the three scenes _scan_scenes writes, in the order they are read
SCAN_FRAMES = (9, 12, 7)
SCAN_WINDOWS = {"estm": [n - 2 for n in SCAN_FRAMES],
                "joint": [len(range(0, n - 5, 3)) for n in SCAN_FRAMES]}


def _scan_scenes(dev, root) -> list[str]:
    """Three ScanNet-layout scenes of SCAN_FRAMES frames under `root`; the
    eval tools' flags that scan them on `dev` at the small size."""
    from estdepth_tpu_torch.data.synthetic import (
        SyntheticSceneConfig, pose, write_scannet_scene,
    )

    torch.backends.cudnn.allow_tf32 = False
    for seed, n in enumerate(SCAN_FRAMES):
        cfg = SyntheticSceneConfig(height=96, width=128, focal=115.574,
                                   seed=seed)
        write_scannet_scene(
            str(root / f"scene{seed:04d}_00"), cfg,
            [pose(cfg, i) @ _pose(0.0, 0.011 * i, 0.0, 0.0,
                                  0.013 * i + 0.002).numpy()
             for i in range(n)])
    return ["--datapath", str(root), "--height", "64", "--width", "96",
            "--ndepths", "8", "--resnet", "18", "--frame-interval", "1",
            "--depth-min", "0.5", "--depth-max", "8.0", "--scan",
            "--device", str(dev)]


def test_bf16_scene_batch_on_the_card_launches_as_one_scene(dev, tmp_path):
    """Both eval tools at --scan --bf16 over the three scenes of
    test_scene_batch_on_the_card_equals_one_scene_at_a_time: the
    --scene-batch 2 maps within twice the --scene-batch 1 bf16 maps'
    distance from the float32 ones (cuDNN's other algorithm at another
    batch rounds bf16 elsewhere), and a group of scenes launches each
    kernel as its longest scene alone does (the batch folds into each
    launch; bf16 instances only): one sweep a window step, one exact-z
    warp a step with EST (ESTM: a step; Joint: a target of a window)
    after the first."""
    from estdepth_tpu_torch.tools import eval_estm, eval_joint

    argv = _scan_scenes(dev, tmp_path)
    for tool, protocol, per_window in ((eval_estm, "estm", 1),
                                       (eval_joint, "joint", 3)):
        maps = {}
        for batch, dtype in ((1, "float32"), (1, "bfloat16"),
                             (2, "bfloat16")):
            before = _counts()
            maps[batch, dtype] = np.stack(tool.run(tool.parse_args(
                argv + ["--scene-batch", str(batch)]
                + (["--bf16"] if dtype == "bfloat16" else [])),
                keep_maps=True)["maps"]).astype(np.float32)
            windows = SCAN_WINDOWS[protocol]
            groups = [max(windows[i:i + batch])
                      for i in range(0, len(windows), batch)]
            _assert_launched(before, dtype, {
                "plane_sweep_warp": sum(groups),
                "frustum_warp_exact_z": per_window * sum(
                    n - 1 for n in groups)})
        own = np.abs(maps[1, "bfloat16"] - maps[1, "float32"]).max()
        err = np.abs(maps[2, "bfloat16"] - maps[1, "bfloat16"]).max()
        assert len(maps[2, "bfloat16"]) == len(maps[1, "float32"])
        assert err <= 2 * own, (protocol, err, own)


# ---- the paths at the small size, card against CPU -----------------------

SMALL = dict(ndepths=8, depth_min=0.5, depth_max=8.0, resnet=18)
# the five kernels, in the order of PERF.md's table of TPU kernels
KERNELS = {"plane_sweep_warp": plane_warp.KERNEL,
           "frustum_warp_exact_z": plane_warp_exact_z.KERNEL,
           "two_pass_resample": two_pass.KERNEL,
           "frustum_warp_plane_mix": plane_mix.KERNEL,
           "epipolar_attention": epipolar_attention.KERNEL}
JOINT_MODES = {"plane_mix_exact_z": {},
               "plane_mix": dict(frustum_mode="plane_mix",
                                 use_fused_attention=True)}
# Each path's ModelConfig fields and launches: a 7-frame stream (5 window
# steps, EST from the second: one sweep a step, one exact-z warp a step
# after the first); 3 Joint windows (one sweep launch a window, one
# frustum warp and one attention call a target of each window after the
# first); 2 training steps on 4-frame windows through the two-pass sweep
# (one resample a step, one exact-z warp a target).
PATHS = {
    "stream": ({}, {"plane_sweep_warp": 5, "frustum_warp_exact_z": 4}),
    "joint": (JOINT_MODES["plane_mix_exact_z"],
              {"plane_sweep_warp": 3, "frustum_warp_exact_z": 6}),
    "joint_plane_mix": (JOINT_MODES["plane_mix"],
                        {"plane_sweep_warp": 3, "frustum_warp_plane_mix": 6,
                         "epipolar_attention": 6}),
    "train_two_pass": (dict(two_pass_warp=True),
                       {"two_pass_resample": 2, "frustum_warp_exact_z": 4}),
}
TRAIN_WINDOWS = [(0, 4), (2, 6), (3, 7)]  # frames [lo, hi) of a step


def _pitched_frames(n: int) -> list[dict]:
    """A small synthetic stream (64x96) with a seeded pitch and lift on
    the camera path, so that no warp coordinate sits exactly on the image
    border, where float noise would decide the hard out-of-range mask."""
    from estdepth_tpu_torch.data.synthetic import (
        SyntheticSceneConfig, synthetic_stream,
    )

    frames = list(synthetic_stream(SyntheticSceneConfig(
        height=64, width=96, focal=80.0), n, 0.5, 8.0))
    for i, f in enumerate(frames):
        f["cam_pose"] = f["cam_pose"] @ _pose(
            0.0, 0.011 * i, 0.0, 0.0, 0.013 * i + 0.002).numpy()
    return frames


def _small_model(**options):
    from estdepth_tpu_torch.config import ModelConfig
    from estdepth_tpu_torch.models.estdepth import DepthNetHybrid

    return DepthNetHybrid(ModelConfig(**SMALL, **options), seed=0)


def _stream(model, frames, device) -> list:
    """An ESTMRunner (lwindow 3, memory 2) over frames: each output's 4
    depth scales on the host."""
    from estdepth_tpu_torch.eval.estm import ESTMRunner

    runner = ESTMRunner(model, 64, 96, device=device)
    return [out.float().cpu() for f in frames if (out := runner.push_frame(
        f["img"], f["cam_pose"], f["cam_intr"])) is not None]


def _joint_windows(frames, windows: int):
    """(imgs, poses, intr) of each 5-frame window, advancing by 3."""
    imgs = np.stack([f["img"] for f in frames])[None]
    poses = np.stack([f["cam_pose"] for f in frames])[None]
    return [(imgs[:, 3 * wi:3 * wi + 5], poses[:, 3 * wi:3 * wi + 5],
             frames[0]["cam_intr"][None]) for wi in range(windows)]


def _joint_chain(model, frames, device, windows: int) -> list:
    """A JointRunner over `windows` windows: each window's depth [1, 3, 4,
    H, W] on the host."""
    from estdepth_tpu_torch.tools.eval_joint import JointRunner

    runner = JointRunner(model, device=device)
    return [runner.run_window(*w)[0].float().cpu()
            for w in _joint_windows(frames, windows)]


def _train_steps(model, frames, device, windows) -> tuple[list, dict]:
    """The trainer's step (Adam at the tool's schedule, clip 10) on the
    4-frame windows of frames: (each step's loss, the BatchNorm running
    statistics after the last)."""
    from estdepth_tpu_torch.train.schedule import warmup_multistep_schedule
    from estdepth_tpu_torch.train.trainer import (
        make_optimizer, make_train_step,
    )

    model = model.to(device)
    optimizer, scheduler = make_optimizer(
        model.named_parameters(),
        warmup_multistep_schedule(4e-5, steps_per_epoch=10**6))
    step = make_train_step(model, optimizer, scheduler, 0.5, 8.0)

    def batch(lo, hi):
        arrays = {
            "imgs": np.stack([f["img"] for f in frames[lo:hi]])[None],
            "cam_poses": np.stack([f["cam_pose"]
                                   for f in frames[lo:hi]])[None],
            "cam_intr": frames[0]["cam_intr"][None],
            "dmaps": np.stack([f["dmap"] for f in frames[lo + 1:hi - 1]])[
                None],
            "dmasks": np.stack([f["dmask"]
                                for f in frames[lo + 1:hi - 1]])[None]}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in arrays.items()}

    losses = [float(step(batch(lo, hi), 10.0)["loss"]) for lo, hi in windows]
    return losses, {k: v.float().cpu() for k, v in model.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))}


def _counts() -> dict:
    return {name: (k.launches, k.launches_bf16) for name, k in KERNELS.items()}


def _assert_launched(before: dict, dtype: str, expected: dict) -> None:
    """Each kernel launched as `expected` says (0 where it does not name
    it) since the counts `before`: a bfloat16 run only bf16 instances, a
    float32 run none."""
    torch.cuda.synchronize()
    now = _counts()
    launched = {name: now[name][0] - before[name][0] for name in KERNELS}
    bf16 = {name: now[name][1] - before[name][1] for name in KERNELS}
    assert launched == {**dict.fromkeys(KERNELS, 0), **expected}
    assert bf16 == (launched if dtype == "bfloat16"
                    else dict.fromkeys(KERNELS, 0))


@pytest.mark.parametrize("path", ["joint", "joint_plane_mix",
                                  "train_two_pass"])
def test_path_launches_its_kernels(dev, path):
    """Each path in bf16 launches exactly the kernels PATHS gives it, in
    bf16 instances only. The stream's launches in both dtypes and these
    paths' in float32 are held by the card-against-CPU tests, so that
    between them the paths launch each of the five kernels in each
    dtype."""
    assert set().union(*(k for _, k in PATHS.values())) == set(KERNELS)
    options, expected = PATHS[path]
    model = _small_model(compute_dtype="bfloat16", **options)
    before = _counts()
    if path.startswith("joint"):
        assert len(_joint_chain(model, _pitched_frames(11), dev, 3)) == 3
    else:
        losses, _ = _train_steps(model, _pitched_frames(7), dev,
                                 TRAIN_WINDOWS[:2])
        assert np.isfinite(losses).all()
    _assert_launched(before, "bfloat16", expected)


@pytest.mark.parametrize("mode", JOINT_MODES)
def test_joint_chain_on_the_card_matches_cpu(dev, mode):
    """3 Joint windows on the card through the kernels against the same
    weights on the CPU, with the default exact-z warp and with the
    plane-mix warp and the attention kernel: all 4 depth scales within the
    chain tolerance 8e-3, and the card's run launching its PATHS kernels
    in float32 instances."""
    torch.backends.cudnn.allow_tf32 = False
    frames = _pitched_frames(11)
    outs = {}
    for device in ("cpu", dev):
        before = _counts()
        outs[str(device)] = _joint_chain(_small_model(**JOINT_MODES[mode]),
                                         frames, device, 3)
    _assert_launched(before, "float32", PATHS[
        "joint" if mode == "plane_mix_exact_z" else "joint_plane_mix"][1])
    err = max((a - b).abs().max().item()
              for a, b in zip(outs["cpu"], outs[str(dev)]))
    assert outs[str(dev)][0].shape == (1, 3, 4, 64, 96)
    assert err < 8e-3, err


def test_two_pass_training_steps_on_the_card_match_cpu(dev):
    """3 training steps through the two-pass sweep (kernel 3, its gradient
    autograd of the plain version) on the card against the CPU, from the
    same seeded weights and batches: each step's loss at rtol 3e-3 and
    every BatchNorm running statistic at rtol 5e-3 (atol 5e-4), the
    PARITY.md trajectory tolerances; on the card one two-pass resample a
    step and one exact-z warp a target, in float32 instances."""
    torch.backends.cudnn.allow_tf32 = False
    frames = _pitched_frames(7)
    runs = {}
    for device in ("cpu", dev):
        before = _counts()
        runs[str(device)] = _train_steps(_small_model(two_pass_warp=True),
                                         frames, device, TRAIN_WINDOWS)
    _assert_launched(before, "float32", {"two_pass_resample": 3,
                                         "frustum_warp_exact_z": 6})
    (losses, stats), (want_losses, want_stats) = runs[str(dev)], runs["cpu"]
    np.testing.assert_allclose(losses, want_losses, rtol=3e-3)
    assert want_stats
    for k, want in want_stats.items():
        np.testing.assert_allclose(stats[k].numpy(), want.numpy(), rtol=5e-3,
                                   atol=5e-4, err_msg=k)


@pytest.mark.parametrize("protocol", ["joint_plane_mix", "stream_two_pass",
                                      "stream_bf16"])
def test_card_exported_artifact_matches_the_live_runner(dev, tmp_path,
                                                        protocol):
    """A serving artifact exported on the card, loaded back and fed frame
    by frame: the Joint step with the plane-mix warp and the attention
    kernel (3 windows), the stream step through the two-pass sweep and the
    bf16 stream step (5 window steps each). Its op nodes launch the
    kernels in its dtype's instances (never the plain versions), a bf16
    artifact's memory is bf16, and its maps equal the live runner's on the
    same model within 1e-5 in float32. In bf16 the bound is the export
    tool's own verification bound: the artifact's convolutions take
    cuDNN's heuristic plans and the live matching encoder measured ones,
    and bf16 rounds the two differently."""
    from estdepth_tpu_torch import serving
    from estdepth_tpu_torch.tools.export_serving import VERIFY_TOL

    torch.backends.cudnn.allow_tf32 = False
    scales = (0, 2)
    dtype = "bfloat16" if protocol == "stream_bf16" else "float32"
    if protocol == "joint_plane_mix":
        model = _small_model(**JOINT_MODES["plane_mix"])
        serving.export_joint(model, height=64, width=96, output_scales=scales,
                             device=dev).save(str(tmp_path))
        runner = serving.load_joint(str(tmp_path), device=dev)
        frames = _pitched_frames(11)
        expected = PATHS["joint_plane_mix"][1]
        want = [out[:, :, list(scales)]
                for out in _joint_chain(model, frames, dev, 3)]
    else:
        model = _small_model(**({"two_pass_warp": True}
                                if protocol == "stream_two_pass"
                                else {"compute_dtype": dtype}))
        serving.export_stream(model, height=64, width=96,
                              output_scales=scales, device=dev).save(
            str(tmp_path))
        runner = serving.load_stream(str(tmp_path), device=dev)
        assert runner.manifest["memory_dtype"] == dtype
        frames = _pitched_frames(7)
        expected = ({"two_pass_resample": 5, "frustum_warp_exact_z": 4}
                    if protocol == "stream_two_pass" else PATHS["stream"][1])
        want = [out[:, list(scales)] for out in _stream(model, frames, dev)]
    before = _counts()
    got = [out for f in frames if (out := runner.push_frame(
        f["img"], f["cam_pose"], f["cam_intr"])) is not None]
    _assert_launched(before, dtype, expected)
    assert len(got) == len(want) == (3 if protocol.startswith("joint")
                                     else 5)
    tol = VERIFY_TOL if dtype == "bfloat16" else 1e-5
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.float().cpu(), w, rtol=tol, atol=tol)


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


# CasMVSNet's stages at the DTU setting (models/casmvsnet.py): h, w, C, D
MVS_STAGES = [(288, 400, 32, 48), (576, 800, 16, 32), (1152, 1600, 8, 8)]


def _mvs_views(dev, h, w, c, d, sources=4, seed=0):
    """One CasMVSNet stage of a DTU-like request: features [1, V, h, w, C]
    of a reference and `sources` source views 3 cm apart at the DTU
    focal, their projections [1, V, 4, 4] and per-pixel hypotheses
    [1, D, h, w] around a depth map near 0.65 m."""
    gen = torch.Generator().manual_seed(seed)
    f = 2892.33 * w / 1600
    k = torch.tensor([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]])
    poses = torch.stack([torch.eye(4)] + [
        _pose(0.03 * i * (-1) ** i, -0.01 * i, -0.009 * i, 0.004 * i, 0.002)
        for i in range(1, sources + 1)])
    proj = geometry.camera_projection(k.expand(sources + 1, 3, 3), poses)
    maps = torch.randn(1, sources + 1, h, w, c, generator=gen)
    centre = 0.6 + 0.1 * torch.rand(1, h, w, generator=gen)
    hyp = centre[:, None] + torch.linspace(-0.085, 0.085, d)[
        None, :, None, None]
    return maps.to(dev), proj[None].to(dev), hyp.to(dev)


def _swept(maps, proj, hyp):
    """The reference's features and each source view swept by kernel 1."""
    return maps[:, 0].contiguous(), [
        warp.plane_sweep_warp(maps[:, i].contiguous(), proj[:, i],
                              proj[:, 0], hyp)
        for i in range(1, maps.shape[1])]


def _variance_launch(ref, warped):
    before = view_variance.KERNEL.launches
    got = view_variance.view_variance(ref, warped)
    assert view_variance.KERNEL.launches == before + 1
    b, h, w, c = ref.shape
    assert got.shape == (b, c, warped[0].shape[1], h, w)
    assert got.is_contiguous()
    return got


@pytest.mark.parametrize("stage", range(len(MVS_STAGES)))
def test_view_variance_kernel_at_the_dtu_stages(dev, stage):
    """The variance kernel at each stage's shape (its C = 32, 16, 8
    instances) on 4 real per-pixel sweeps: `torch.equal` to its plain
    version on the same card tensors, one launch a call."""
    h, w, c, d = MVS_STAGES[stage]
    ref, warped = _swept(*_mvs_views(dev, h, w, c, d, seed=stage))
    assert all((x == 0).any() and (x != 0).any() for x in warped)
    got = _variance_launch(ref, warped)
    assert torch.equal(got, view_variance.view_variance_plain(ref, warped))


@pytest.mark.parametrize("sources,c,w", [
    (1, 8, 33), (16, 8, 33), (4, 16, 31), (16, 32, 17), (2, 32, 45),
    (3, 12, 33), (5, 4, 31), (4, 64, 21)])
def test_view_variance_kernel_at_odd_widths_and_view_counts(dev, sources,
                                                            c, w):
    """Odd widths (a ragged last tile of each plane), 1 and 16 source
    views, and channel counts of the generic instance (C = 12, 4, 64):
    bit for bit the plain version."""
    ref, warped = _swept(*_mvs_views(dev, 24, w, c, 7, sources, seed=w))
    got = _variance_launch(ref, warped)
    assert torch.equal(got, view_variance.view_variance_plain(ref, warped))
    assert (got != 0).any()


def test_view_variance_kernel_refuses_what_it_cannot_take(dev):
    """17 source views, a float64 or bfloat16 input, a strided volume or
    a volume of another shape raise before any launch."""
    ref, warped = _swept(*_mvs_views(dev, 24, 32, 8, 5, 1))
    vol = warped[0]
    before = view_variance.KERNEL.launches
    for error, args in [
            (ValueError, (ref, [vol] * 17)),
            (TypeError, (ref.double(), [vol.double()])),
            (TypeError, (ref, [vol.bfloat16()])),
            (ValueError, (ref, [vol.transpose(2, 3).contiguous()
                                .transpose(2, 3)])),
            (ValueError, (ref, [vol, vol[:, :4].contiguous()])),
            (ValueError, (ref.cpu(), [vol]))]:
        with pytest.raises(error):
            view_variance.view_variance(*args)
    assert view_variance.KERNEL.launches == before


def test_casmvsnet_cost_volume_on_the_card_is_its_plain_version(dev):
    """A stage-2 cost volume of CascadeMVSNet at the DTU setting (the
    model's own hypotheses around a stage-1 depth map): `_variance` on
    the card launches kernel 1 once a source view and the variance kernel
    once, and equals the variance computed on the same card tensors by
    the module's plain function, called directly."""
    from estdepth_tpu_torch.config import CascadeConfig
    from estdepth_tpu_torch.models.casmvsnet import CascadeMVSNet

    h, w, c, d = MVS_STAGES[1]
    model = CascadeMVSNet(CascadeConfig())
    assert model.cfg.stage_planes[1] == d
    maps, proj, _ = _mvs_views(dev, h, w, c, d, seed=5)
    prev = 0.6 + 0.1 * torch.rand(1, h // 2, w // 2,
                                  generator=torch.Generator().manual_seed(6))
    hyp = model._hypotheses(1, prev.to(dev), 1, 2 * h, 2 * w, dev)
    assert hyp.shape == (1, d, h, w)
    sweeps = plane_warp.KERNEL.launches
    variances = view_variance.KERNEL.launches
    with torch.inference_mode():
        got = model._variance(maps, proj, hyp)
    assert plane_warp.KERNEL.launches == sweeps + 4
    assert view_variance.KERNEL.launches == variances + 1
    assert torch.equal(got, view_variance.view_variance_plain(
        *_swept(maps, proj, hyp)))


def _correlation_launch(ref, warped):
    before = view_correlation.KERNEL.launches
    got = view_correlation.view_correlation(ref, warped)
    assert view_correlation.KERNEL.launches == before + 1
    assert got.shape == warped.shape[:-1] and got.is_contiguous()
    return got


def _correlation_gap(got, ref, warped) -> float:
    """The largest |kernel - plain| over its bound 4 C 2^-23 mean_c
    |warped_c ref_c| at any voxel (0 where both are exactly 0); asserts
    that none exceeds 1."""
    want = view_correlation.view_correlation_plain(ref, warped)
    bound = (warped * ref[:, None]).abs_().mean(-1).mul_(
        4 * ref.shape[-1] * 2.0 ** -23)
    gap = (got - want).abs_()
    assert bool((gap <= bound).all()), float((gap - bound).max())
    return float((gap / bound.clamp_min(torch.finfo(torch.float32).tiny))
                 .max())


@pytest.mark.parametrize("stage", range(len(MVS_STAGES)))
def test_view_correlation_kernel_at_the_dtu_stages(dev, stage):
    """The correlation kernel at each stage's shape (its C = 32, 16, 8
    instances) on 4 real per-pixel sweeps, zeros outside the source
    view included: within the per-voxel bound of its plain version on
    the same card tensors, one launch a call."""
    h, w, c, d = MVS_STAGES[stage]
    ref, warped = _swept(*_mvs_views(dev, h, w, c, d, seed=stage))
    for vol in warped:
        assert (vol == 0).any() and (vol != 0).any()
        got = _correlation_launch(ref, vol)
        assert _correlation_gap(got, ref, vol) <= 1
        assert (got != 0).any()
        del got


@pytest.mark.parametrize("b,c,w,d", [
    (2, 8, 33, 7), (1, 16, 31, 13), (2, 32, 17, 9), (1, 32, 45, 3),
    (2, 4, 31, 7), (1, 12, 33, 9), (2, 64, 21, 5), (1, 8, 1, 17)])
def test_view_correlation_kernel_at_odd_widths_and_channels(dev, b, c, w,
                                                            d):
    """Odd widths (a warp's ragged last pixels), plane counts that end a
    block's chunk of 8 or a step of its loads early, batch 2, and
    channel counts of the generic instance (C = 4, 12, 64): within the
    per-voxel bound of the plain version."""
    gen = torch.Generator().manual_seed(c * w + d)
    ref = torch.randn(b, 24, w, c, generator=gen).to(dev)
    warped = torch.randn(b, d, 24, w, c, generator=gen).to(dev)
    got = _correlation_launch(ref, warped)
    assert _correlation_gap(got, ref, warped) <= 1


def test_view_correlation_kernel_refuses_what_it_cannot_take(dev):
    """A float64 or bfloat16 input, a strided volume, a volume of another
    shape, C % 4 != 0 or a reference on another device raise before any
    launch."""
    ref, warped = _swept(*_mvs_views(dev, 24, 32, 8, 5, 1))
    vol = warped[0]
    before = view_correlation.KERNEL.launches
    for error, args in [
            (TypeError, (ref.double(), vol.double())),
            (TypeError, (ref, vol.bfloat16())),
            (ValueError, (ref, vol.transpose(2, 3).contiguous()
                          .transpose(2, 3))),
            (ValueError, (ref, vol[:, :, 1:].contiguous())),
            (ValueError, (ref[..., :6].contiguous(),
                          vol[..., :6].contiguous())),
            (ValueError, (ref.cpu(), vol))]:
        with pytest.raises(error):
            view_correlation.view_correlation(*args)
    assert view_correlation.KERNEL.launches == before


def test_transmvsnet_correlates_each_source_view_once_a_stage(dev):
    """A 5-view TransMVSNet request through MVSRunner on the card at the
    small size (64x96, 8/8/8 planes): each stage's cost volume launches
    kernel 1 and the correlation kernel once a source view, 4 a stage,
    and the depth and confidence are finite, the confidence a
    probability."""
    from estdepth_tpu_torch.config import CascadeConfig
    from estdepth_tpu_torch.eval.mvs import MVSRunner
    from estdepth_tpu_torch.models.transmvsnet import TransMVSNet
    from portbench.harness.scenes import Path, make_scenes

    torch.backends.cudnn.allow_tf32 = False
    h, w = 64, 96
    model = TransMVSNet(CascadeConfig(stage_planes=(8, 8, 8)), seed=3)
    path = Path(height=h, width=w, frames=5, step_x=0.03, step_z=-0.0045,
                yaw_per_frame=0.002, plane_offset=(0.6, 0.75),
                focal=2892.33 * w / 1600)
    scene = make_scenes(path, 1, 5, torch.device("cpu"))[0]
    order = [2, 1, 3, 0, 4]
    views = (torch.from_numpy(scene.frames[order])[None],
             torch.from_numpy(scene.poses[order])[None],
             torch.from_numpy(scene.intr)[None])
    stages = []
    inner = model._cost_volume

    def counted(*args):
        sweeps = plane_warp.KERNEL.launches
        correlations = view_correlation.KERNEL.launches
        out = inner(*args)
        stages.append((plane_warp.KERNEL.launches - sweeps,
                       view_correlation.KERNEL.launches - correlations))
        return out

    model._cost_volume = counted
    depth, confidence = MVSRunner(model, device=dev).run_view(*views)
    assert stages == [(4, 4)] * 3
    assert bool(torch.isfinite(depth).all()) and float(depth.min()) > 0
    assert bool(((confidence > 0) & (confidence <= 1)).all())


def test_transmvsnet_on_the_card_follows_the_cpu_reference(dev):
    """TransMVSNet through MVSRunner on the card (kernel 1 once a source
    view a stage, cuDNN's measured plans for the U-Nets) at the small size
    (3 views at 64x96, 8/8/8 planes) against the plain reference on the
    CPU, its stages 2 and 3 started from the card's previous-stage depth.
    Where both argmaxes agree the depth is the same hypothesis up to the
    rounding of the bilinear resize of the previous depth on either device
    (1e-6 m); the card's convolutions and reductions sum in another order
    than the CPU's, which moves a probability by ~1e-5, so at most 1% of
    the 8064 pixels' argmaxes may flip and the confidence is held to 1e-4
    where they agree."""
    from estdepth_tpu_torch.config import CascadeConfig
    from estdepth_tpu_torch.eval.mvs import MVSRunner
    from estdepth_tpu_torch.models.transmvsnet import TransMVSNet
    from portbench.harness.scenes import Path, make_scenes
    from portbench.reference.transmvsnet import TransMVSNet as Reference

    torch.backends.cudnn.allow_tf32 = False
    h, w = 64, 96
    cfg = CascadeConfig(stage_planes=(8, 8, 8))
    model = TransMVSNet(cfg, seed=3)
    ref = Reference(cfg.stage_planes, cfg.interval_ratios, cfg.ndepths,
                    cfg.depth_min, cfg.depth_interval)
    ref.load_state_dict(model.state_dict(), strict=True)
    path = Path(height=h, width=w, frames=4, step_x=0.03, step_z=-0.0045,
                yaw_per_frame=0.002, plane_offset=(0.6, 0.75),
                focal=2892.33 * w / 1600)
    scene = make_scenes(path, 1, 5, torch.device("cpu"))[0]
    poses = scene.poses[[2, 1, 3]].copy()
    poses[1:, 1, 3] += np.float32(0.004)
    views = (torch.from_numpy(scene.frames[[2, 1, 3]])[None],
             torch.from_numpy(poses)[None],
             torch.from_numpy(scene.intr)[None])
    sweeps = plane_warp.KERNEL.launches
    got = MVSRunner(model, return_all=True, device=dev).run_view(*views)
    assert plane_warp.KERNEL.launches == sweeps + 3 * 2
    got = {k: [t.cpu() for t in v] if isinstance(v, list) else v.cpu()
           for k, v in got.items()}
    with torch.inference_mode():
        want = ref.eval()(*views, prev_depths=got["stage_depths"][:2])
    flips = 0
    for k in range(3):
        same = got["stage_indices"][k] == want["stage_indices"][k]
        flips += int((~same).sum())
        torch.testing.assert_close(got["stage_depths"][k][same],
                                   want["stage_depths"][k][same],
                                   atol=1e-6, rtol=0)
    assert flips <= 0.01 * (16 * 24 + 32 * 48 + h * w), flips
    same = got["index"] == want["index"]
    torch.testing.assert_close(got["confidence"][same],
                               want["confidence"][same], atol=1e-4, rtol=0)


def _vggt_middle(dev, compute_dtype="bfloat16"):
    """VGGT at the published widths with 4 DINOv2 blocks, 4 aggregator
    iterations and the DPT head on outputs 0-3, its port and its
    reference on the card with one state from the benchmark's family."""
    import dataclasses

    from estdepth_tpu_torch.config import VGGTConfig
    from portbench.harness import models

    cfg = dataclasses.asdict(VGGTConfig(
        dino_depth=4, aa_depth=4, dpt_layers=(0, 1, 2, 3),
        compute_dtype=compute_dtype))
    config = {"family": "vggt", "model": {
        k: list(v) if isinstance(v, tuple) else v for k, v in cfg.items()}}
    state = models.weights(config, 7, dev)
    return (models.port(config, state, dev),
            models.reference(config, state, dev))


def test_vggt_bf16_autocast_follows_the_float32_reference(dev):
    """VGGT at a middle size (published widths, 4 + 4 blocks, 8 frames of
    1152x1600 resized to 378x518: global attention over 8,032 tokens)
    through MVSRunner on the card under bf16 autocast, against the plain
    float32 reference (TF32 off) and the reference cast wholly to bf16:
    every gap of the program's logits and poses, largest and median, lies
    below the bf16 control's, and the depth is finite and positive. No
    fixed tolerance: bf16 GEMMs move a logit by ~1e-2 at this depth."""
    from estdepth_tpu_torch.eval.mvs import MVSRunner
    from portbench.harness.scenes import Path, make_scenes

    torch.backends.cudnn.allow_tf32 = False
    port, ref = _vggt_middle(dev)
    path = Path(height=1152, width=1600, frames=8, step_x=0.03,
                step_z=-0.0045, yaw_per_frame=0.002,
                plane_offset=(0.6, 0.75), focal=2892.33)
    scene = make_scenes(path, 1, 5, dev)[0]
    views = (scene.frames[None], scene.poses[None], scene.intr[None])
    got = MVSRunner(port, return_all=True, device=dev).run_view(*views)
    assert got["depth"].shape == (1, 8, 378, 518)
    assert bool(torch.isfinite(got["depth"]).all())
    assert float(got["depth"].min()) > 0
    imgs = torch.as_tensor(scene.frames[None]).to(dev)
    with torch.inference_mode():
        want = ref(imgs)
        control = ref.to(torch.bfloat16)(imgs)
    gaps = {}
    for k in ("depth_logit", "confidence_logit", "pose_enc"):
        g = (got[k] - want[k]).abs()
        c = (control[k].float() - want[k]).abs()
        gaps[k] = (float(g.max()), float(c.max()), float(g.median()),
                   float(c.median()))
    print("vggt middle gaps (program max, control max, program median, "
          "control median):", gaps)
    for k, (g, c, gm, cm) in gaps.items():
        assert g < c and gm < cm, (k, gaps[k])


def test_vggt_attention_runs_a_fused_sdpa_backend(dev):
    """A global block's attention op (q, k, v [1, 16, 49196, 64] bf16, a
    49-frame scan's) on the card: the kernel SDPA picked is a fused one
    (flash, cuDNN or memory-efficient), not the math path's GEMMs and
    softmax, and its output is within bf16 rounding of a float32
    reference on the first 256 query rows. Prints the kernel's name."""
    from estdepth_tpu_torch.ops.attention import attention

    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, 16, 49196, 64, device=dev, generator=gen,
                           dtype=torch.bfloat16) for _ in range(3))
    attention(q, k, v)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = attention(q, k, v)
        torch.cuda.synchronize()
    kernels = {e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    print("vggt attention kernels:", sorted(kernels))
    assert any(("flash" in n.lower() or "fmha" in n.lower()
                or "cudnn" in n.lower() or "sdpa" in n.lower()
                or "attention" in n.lower()) for n in kernels), kernels
    assert not any("softmax" in n.lower() for n in kernels), kernels
    qf, kf, vf = (t[:, :, :256].float() if t is q else t.float()
                  for t in (q, k, v))
    want = torch.softmax(qf @ kf.transpose(-2, -1) / 8.0, -1) @ vf
    torch.testing.assert_close(out[:, :, :256].float(), want, atol=2e-2,
                               rtol=0)


# ---- the EST GRU's GroupNorms: estdepth::group_norm_act ------------------

GN_EPS = 1e-5
# the GRU's two calls at the flagship volume (16 channels, D = 64, 64x80):
# the gates' two norms in one call, the output norm
GRU_NORMS = [((1, 32, 64, 64, 80), 2, "sigmoid"),
             ((1, 16, 64, 64, 80), 1, "tanh")]


def _norm_inputs(dev, shape, dtype=torch.float32, seed=0):
    """x around 0.5 with spread 2, trained-looking weight and bias."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x = (2.0 * torch.randn(shape, device=dev, generator=gen) + 0.5).to(dtype)
    weight = 1.0 + 0.2 * torch.randn(c, device=dev, generator=gen)
    bias = 0.2 * torch.randn(c, device=dev, generator=gen)
    return x, weight, bias


def _gap_in_ulps_of_scale(got, want) -> float:
    """max |got - want| over the spacing eps(dtype) max |want|."""
    scale = want.float().abs().max().item()
    return ((got.float() - want.float()).abs().max().item()
            / (torch.finfo(want.dtype).eps * scale))


def _norm_launch(x, weight, bias, groups, act):
    """One call through the kernel, counted: the op's two passes are one
    launch of `build.Kernel`."""
    kernel = group_norm_act.KERNEL
    before = (kernel.launches, kernel.launches_bf16)
    got = group_norm_act.group_norm_act(x, weight, bias, groups, GN_EPS, act)
    assert kernel.launches == before[0] + 1
    assert kernel.launches_bf16 == before[1] + (x.dtype == torch.bfloat16)
    return got


def _stats_gap(x, groups) -> tuple[float, float]:
    """The largest relative gaps of the kernel's mean and rstd from float64
    statistics, over the (sample, group) rows. The kernel's are read off
    its output without an activation (weight 1, bias 0): the float64
    least-squares line of that output over x has slope rstd and crosses
    0 at the mean."""
    n, c = x.shape[:2]
    ones = torch.ones(c, device=x.device)
    y = _norm_launch(x, ones, torch.zeros_like(ones), groups, "none")
    xd = x.double().reshape(n, groups, -1)
    yd = y.double().reshape(n, groups, -1)
    xc = xd - xd.mean(-1, keepdim=True)
    rstd = (xc * (yd - yd.mean(-1, keepdim=True))).sum(-1) / (
        xc.square().sum(-1))
    mean = xd.mean(-1) - yd.mean(-1) / rstd
    want_mean = xd.mean(-1)
    want_rstd = torch.rsqrt(xd.var(-1, unbiased=False) + GN_EPS)
    return (float(((mean - want_mean).abs() / want_mean.abs()).max()),
            float(((rstd - want_rstd).abs() / want_rstd).max()))


@pytest.mark.parametrize("shape, groups, act", GRU_NORMS + [
    ((3, 32, 64, 64, 80), 2, "sigmoid")])
def test_group_norm_act_kernel_at_the_gru_shapes(dev, shape, groups, act):
    """The GRU's two calls (and the gates of 3 targets at once, the
    non-sequential fusion): within 4 float32 ulps of the output's scale
    of the plain version (ATen's group norm and activation, whose float32
    sums run in another order), the same output on a second run, and
    mean and rstd within 1e-6 of float64 statistics."""
    x, weight, bias = _norm_inputs(dev, shape)
    got = _norm_launch(x, weight, bias, groups, act)
    want = group_norm_act.group_norm_act_plain(x, weight, bias, groups,
                                               GN_EPS, act)
    gap = _gap_in_ulps_of_scale(got, want)
    print(f"group_norm_act {shape} {act}: {gap} ulps of the scale")
    assert gap <= 4, gap
    assert torch.equal(got, _norm_launch(x, weight, bias, groups, act))
    mean_gap, rstd_gap = _stats_gap(x, groups)
    assert mean_gap <= 1e-6 and rstd_gap <= 1e-6, (mean_gap, rstd_gap)


@pytest.mark.parametrize("act", ["sigmoid", "tanh", "none"])
def test_group_norm_act_kernel_at_odd_misaligned_rows(dev, act):
    """Rows of 315 values (3 channels of 5 x 7 x 3 a group), so that every
    row after the first starts off a 16-byte boundary, on a tensor whose
    own base is off one too: the scalar heads and tails."""
    shape = (2, 9, 5, 7, 3)
    _, weight, bias = _norm_inputs(dev, shape)
    buf = 2.0 * torch.randn(math.prod(shape) + 1, device=dev) + 0.5
    x = buf[1:].view(shape)
    assert x.data_ptr() % 16
    got = _norm_launch(x, weight, bias, 3, act)
    want = group_norm_act.group_norm_act_plain(x, weight, bias, 3, GN_EPS,
                                               act)
    assert _gap_in_ulps_of_scale(got, want) <= 4
    mean_gap, rstd_gap = _stats_gap(x, 3)
    assert mean_gap <= 1e-5 and rstd_gap <= 1e-6, (mean_gap, rstd_gap)


@pytest.mark.parametrize("shape, groups, act", GRU_NORMS)
def test_group_norm_act_bf16_instance_within_one_ulp(dev, shape, groups,
                                                     act):
    """bf16 volumes: float32 statistics and affine map, rounded to bf16,
    the activation rounded once: within one bf16 ulp of the output's
    scale of the plain version, and the same output on a second run."""
    x, weight, bias = _norm_inputs(dev, shape, torch.bfloat16)
    got = _norm_launch(x, weight, bias, groups, act)
    want = group_norm_act.group_norm_act_plain(x, weight, bias, groups,
                                               GN_EPS, act)
    assert got.dtype == torch.bfloat16
    assert _gap_in_ulps_of_scale(got, want) <= 1
    assert torch.equal(got, _norm_launch(x, weight, bias, groups, act))


def test_group_norm_act_kernel_refuses_what_it_cannot_take(dev):
    x, weight, bias = _norm_inputs(dev, (1, 16, 4, 8, 8))
    kernel = group_norm_act.KERNEL
    before = kernel.launches
    for args, error in [
            ((x.half(), weight, bias, 1, "tanh"), TypeError),
            ((x.transpose(2, 3), weight, bias, 1, "tanh"), ValueError),
            ((x, weight, bias, 3, "tanh"), ValueError),
            ((x, weight[:8], bias, 1, "tanh"), ValueError),
            ((x, weight, bias.cpu(), 1, "tanh"), ValueError),
            ((x, weight, bias, 1, "gelu"), ValueError)]:
        with pytest.raises(error):
            group_norm_act.group_norm_act(args[0], args[1], args[2],
                                          args[3], GN_EPS, args[4])
    assert kernel.launches == before


@pytest.mark.parametrize("path", ["stream", "joint", "train"])
def test_gru_launches_group_norm_act_twice_a_grad_free_call(dev, path):
    """At the small size, each GRU call of the stream and of the Joint
    chain launches the kernel twice (the gates, the output norm), and a
    training step's none: grad on keeps the modules."""
    model = _small_model()
    gru = model.CostRegNet.epipolar_transformer
    calls = []
    handle = gru.register_forward_hook(lambda *_: calls.append(1))
    before = group_norm_act.KERNEL.launches
    try:
        if path == "stream":
            assert len(_stream(model, _pitched_frames(5), dev)) == 3
        elif path == "joint":
            assert len(_joint_chain(model, _pitched_frames(8), dev, 2)) == 2
        else:
            losses, _ = _train_steps(model, _pitched_frames(5), dev,
                                     TRAIN_WINDOWS[:1])
            assert np.isfinite(losses).all()
    finally:
        handle.remove()
    torch.cuda.synchronize()
    assert calls
    launched = group_norm_act.KERNEL.launches - before
    assert launched == (0 if path == "train" else 2 * len(calls))


def _mvs_request(dev, views: int, height: int, width: int):
    """A request of `views` frames of a synthetic scan (the benchmark's
    camera path, DTU's field of view), as numpy arrays."""
    from portbench.harness.scenes import Path, make_scenes

    path = Path(height=height, width=width, frames=views, step_x=0.03,
                step_z=-0.0045, yaw_per_frame=0.002,
                plane_offset=(0.6, 0.75), focal=2892.33 * width / 1600)
    scene = make_scenes(path, 1, 5, dev)[0]
    return scene.frames[None], scene.poses[None], scene.intr[None]


def _steady_request(path: str, dev):
    """(warm-up, request) of one runner at the small size: the request is
    a steady one (a stream frame, a Joint window and a training step with
    EST on a memory, an MVS request after the first), its inputs as the
    benchmark hands them over (numpy frames; a training batch already on
    the device)."""
    from estdepth_tpu_torch.config import CascadeConfig
    from estdepth_tpu_torch.eval.mvs import MVSRunner

    if path == "stream":
        from estdepth_tpu_torch.eval.estm import ESTMRunner

        frames = _pitched_frames(5)
        runner = ESTMRunner(_small_model(), 64, 96, output_scales=(0, 2),
                            device=dev)
        return (lambda: [runner.push_frame(f["img"], f["cam_pose"],
                                           f["cam_intr"])
                         for f in frames[:4]],
                lambda: runner.push_frame(frames[4]["img"],
                                          frames[4]["cam_pose"],
                                          frames[4]["cam_intr"]))
    if path == "joint":
        from estdepth_tpu_torch.tools.eval_joint import JointRunner

        windows = _joint_windows(_pitched_frames(8), 2)
        runner = JointRunner(_small_model(), device=dev)
        return (lambda: runner.run_window(*windows[0]),
                lambda: runner.run_window(*windows[1]))
    if path == "train":
        from estdepth_tpu_torch.train.trainer import (
            make_optimizer, make_train_step,
        )

        frames = _pitched_frames(5)
        model = _small_model().to(dev)
        optimizer, scheduler = make_optimizer(model.named_parameters(),
                                              lambda step: 4e-5)
        step = make_train_step(model, optimizer, scheduler, 0.5, 8.0)
        arrays = {
            "imgs": np.stack([f["img"] for f in frames])[None],
            "cam_poses": np.stack([f["cam_pose"] for f in frames])[None],
            "cam_intr": frames[0]["cam_intr"][None],
            "dmaps": np.stack([f["dmap"] for f in frames[1:4]])[None],
            "dmasks": np.stack([f["dmask"] for f in frames[1:4]])[None]}
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in arrays.items()}
        return (lambda: step(batch, 10.0), lambda: step(batch, 10.0))
    if path == "vggt":
        model, _ = _vggt_middle(dev)
        views = _mvs_request(dev, 4, 1152, 1600)
    else:
        from estdepth_tpu_torch.models.casmvsnet import CascadeMVSNet
        from estdepth_tpu_torch.models.transmvsnet import TransMVSNet

        net = CascadeMVSNet if path == "casmvsnet" else TransMVSNet
        model = net(CascadeConfig(stage_planes=(8, 8, 8)), seed=3)
        views = _mvs_request(dev, 5, 64, 96)
    runner = MVSRunner(model, device=dev)
    return (lambda: runner.run_view(*views),
            lambda: runner.run_view(*views))


@pytest.mark.parametrize("path", ["stream", "joint", "train", "casmvsnet",
                                  "transmvsnet", "vggt"])
def test_a_steady_request_syncs_only_inside_host_waits(dev, path,
                                                        monkeypatch):
    """Under `torch.cuda.set_sync_debug_mode("warn")` every call of a
    steady request at which the host waits on the card lies inside a
    `utils/trace.host_wait` span: each sync warning is raised while one is
    open. Each request syncs at least once (its upload, a pose inverse)."""
    import traceback
    import warnings

    from estdepth_tpu_torch.utils import trace

    torch.backends.cudnn.allow_tf32 = False
    warm, request = _steady_request(path, dev)
    warm()
    torch.cuda.synchronize()
    depth = [0]
    real = trace.host_wait

    @contextlib.contextmanager
    def counted(kind):
        depth[0] += 1
        try:
            with real(kind):
                yield
        finally:
            depth[0] -= 1

    monkeypatch.setattr(trace, "host_wait", counted)
    syncs = []

    def show(message, *args, **kwargs):
        if "synchronizing" in str(message):
            syncs.append((depth[0] > 0,
                          "".join(traceback.format_stack(limit=8)[:-1])))

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            request()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    outside = [stack for inside, stack in syncs if not inside]
    assert syncs
    assert not outside, outside[0]
