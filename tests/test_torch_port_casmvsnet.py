"""CasMVSNet in the port (models/casmvsnet.py, eval/mvs.py) against the
benchmark's plain reference (portbench/reference/casmvsnet.py), and the
shared code it changed: per-pixel depth hypotheses in the plane sweep
(ops/warp.py) and the expected depth over them (models/decoder.py).

The small size is 3 views at 64x96 with the published channel widths and
16/8/8 planes, on seeded random weights with randomized BatchNorm
statistics and scales, so that no block is an identity. The JAX package
has no CasMVSNet: the reference is the plain float32 forward written
from the published code.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from estdepth_tpu_torch.config import CascadeConfig
from estdepth_tpu_torch.eval.mvs import MVSRunner
from estdepth_tpu_torch.models import decoder
from estdepth_tpu_torch.models.casmvsnet import (
    CascadeMVSNet, photometric_confidence,
)
from estdepth_tpu_torch.ops import geometry, shard_context, warp
from estdepth_tpu_torch.utils import trace
from portbench.harness.scenes import Path, make_scenes
from portbench.reference import casmvsnet as reference
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W = 64, 96
CFG = CascadeConfig(stage_planes=(16, 8, 8))
VIEWS = [2, 1, 3]  # the reference and its two nearest views


def _randomize_bn(model: nn.Module, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                assert m.running_var.shape == (n,)


@pytest.fixture(scope="module")
def models():
    """The port's model and the reference on one state_dict."""
    port = CascadeMVSNet(CFG, seed=3)
    _randomize_bn(port, 4)
    ref = reference.CascadeMVSNet(
        CFG.stage_planes, CFG.interval_ratios, CFG.ndepths, CFG.depth_min,
        CFG.depth_interval)
    ref.load_state_dict(port.state_dict(), strict=True)
    return port, ref.eval()


@pytest.fixture(scope="module")
def views():
    """A 3-view request of a synthetic scan (the benchmark's camera path,
    DTU's field of view at 96 wide), as uint8 frames and float32 poses."""
    path = Path(height=H, width=W, frames=4, step_x=0.03, step_z=-0.0045,
                yaw_per_frame=0.002, plane_offset=(0.6, 0.75),
                focal=2892.33 * W / 1600)
    scene = make_scenes(path, 1, 5, torch.device("cpu"))[0]
    # a small pitch and lift: rows that project exactly onto the border
    # flip the hard out-of-range mask on float noise
    poses = scene.poses[VIEWS].copy()
    poses[1:, 1, 3] += np.float32(0.004)
    c, s = np.cos(0.003), np.sin(0.003)
    poses[2, :3, :3] = poses[2, :3, :3] @ np.array(
        [[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    return (torch.from_numpy(scene.frames[VIEWS])[None],
            torch.from_numpy(poses)[None],
            torch.from_numpy(scene.intr)[None])


def test_runner_follows_the_reference(models, views):
    """Each stage's depth, the final confidence and idx of MVSRunner
    against the reference. Both compute in float32 on the CPU; they
    differ in the order of a few sums (batched feature net, bilinear in
    place of trilinear resizes, the sweep's gather against grid_sample),
    which reads ~3e-7 m here: 1e-5 m is 40 float32 ulps at 0.7 m and
    still 100 times under the TF32 reading of the card's limits. An idx
    flips only where sum_i i p_i lies within rounding of an integer,
    so at most a few of 6144 pixels; the confidence is compared where
    the idx agrees, at 1e-5 of a probability."""
    port, ref = models
    depth, confidence = MVSRunner(port, device="cpu").run_view(*views)
    got = MVSRunner(port, return_all=True, device="cpu").run_view(*views)
    index = got["index"]
    with torch.inference_mode():
        want = ref(*views)
    assert torch.equal(got["depth"], depth)
    assert torch.equal(got["confidence"], confidence)
    for k, (g, r) in enumerate(zip(got["stage_depths"],
                                   want["stage_depths"])):
        s = (4, 2, 1)[k]
        assert g.shape == r.shape == (1, H // s, W // s)
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
    same = index == want["index"]
    assert (~same).sum() <= 6
    torch.testing.assert_close(confidence[same], want["confidence"][same],
                               atol=1e-5, rtol=0)
    # the stages narrow the range: stage 1 spans the scan's 0.425-0.931 m
    assert depth.min() > CFG.depth_min and depth.max() < CFG.depth_max
    assert confidence.min() > 0 and confidence.max() <= 1 + 1e-6


def test_reference_started_from_the_ports_stages(models, views):
    """The output check's form: stages 2 and 3 of the reference started
    from the port's previous-stage depths. Their hypotheses and sample
    coordinates are then the port's bit for bit, so no sample crosses the
    hard border mask on rounding; started from its own depths, the
    reference gives its own forward."""
    port, ref = models
    with torch.inference_mode():
        got = port(*views)
        want = ref(*views, prev_depths=got["stage_depths"][:2])
        own = ref(*views)
        assert torch.equal(ref(*views, prev_depths=own["stage_depths"][:2])[
            "depth"], own["depth"])
        for k in (1, 2):
            assert torch.equal(
                port._hypotheses(k, got["stage_depths"][k - 1], 1, H, W,
                                 "cpu"),
                reference.F.interpolate(reference.depth_range_samples(
                    reference.F.interpolate(
                        got["stage_depths"][k - 1][:, None], [H, W],
                        mode="bilinear", align_corners=False)[:, 0],
                    CFG.stage_planes[k],
                    CFG.interval_ratios[k] * CFG.forward_interval,
                    (1, H, W))[:, None],
                    [CFG.stage_planes[k], H // (4 >> k), W // (4 >> k)],
                    mode="trilinear", align_corners=False)[:, 0])
    for g, r in zip(got["stage_depths"], want["stage_depths"]):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
    assert torch.equal(got["index"], want["index"])


def _sweep_inputs():
    b, h, w, c, d = 2, 12, 16, 8, 5
    gen = torch.Generator().manual_seed(0)
    src = torch.randn(b, h, w, c, generator=gen)
    k = torch.tensor([[20.0, 0, (w - 1) / 2], [0, 20.0, (h - 1) / 2],
                      [0, 0, 1]]).expand(b, 3, 3)
    pose = torch.eye(4).expand(b, 4, 4).clone()
    pose[:, 0, 3] = torch.tensor([0.05, -0.04])
    pose[:, 1, 3] = 0.01
    proj = geometry.camera_projection(k, pose)
    ref = geometry.camera_projection(k, torch.eye(4).expand(b, 4, 4))
    planes = torch.linspace(0.5, 2.0, d)[None].expand(b, d) * torch.tensor(
        [[1.0], [1.1]])
    return src, proj, ref, planes


def test_per_pixel_sweep_of_broadcast_planes_is_the_plane_sweep():
    src, proj, ref, planes = _sweep_inputs()
    b, h, w, _ = src.shape
    per_pixel = planes[:, :, None, None].expand(-1, -1, h, w).contiguous()
    assert torch.equal(warp.plane_sweep_warp(src, proj, ref, per_pixel),
                       warp.plane_sweep_warp(src, proj, ref, planes))
    for got, want in zip(warp.plane_sweep_coords(proj, ref, per_pixel, h, w),
                         warp.plane_sweep_coords(proj, ref, planes, h, w)):
        assert torch.equal(got, want)


def test_per_pixel_sweep_refuses_two_pass_shards_and_other_grids():
    src, proj, ref, planes = _sweep_inputs()
    b, h, w, _ = src.shape
    per_pixel = planes[:, :, None, None].expand(-1, -1, h, w).contiguous()
    with pytest.raises(ValueError, match="two_pass"):
        warp.plane_sweep_warp(src, proj, ref, per_pixel, two_pass=True)
    # refused before the layout is asked for anything
    with shard_context.width_sharded(object()), \
            pytest.raises(ValueError, match="width-sharded"):
        warp.plane_sweep_warp(src, proj, ref, per_pixel)
    with pytest.raises(ValueError, match="per-pixel"):
        warp.plane_sweep_warp(src, proj, ref, per_pixel[:, :, :-1])


def test_hypotheses_are_the_published_ranges(models):
    """Stage 1: the D planes spread over [d_min, d_max] at every pixel.
    Stages 2 and 3: the previous depth upsampled bilinearly to the image
    (align_corners False), lo / hi = d -/+ D/2 r delta (delta the forward
    interval (d_max - d_min) / D0), D hypotheses lo + i (hi - lo) / (D-1),
    resized bilinearly to the stage's size: against the reference's
    get_depth_range_samples and trilinear resize, within an ulp."""
    port, _ = models
    gen = torch.Generator().manual_seed(2)
    one = port._hypotheses(0, None, 2, H, W, "cpu")
    d = CFG.stage_planes[0]
    assert one.shape == (2, d, H // 4, W // 4)
    want = torch.linspace(CFG.depth_min, CFG.depth_max, d)
    torch.testing.assert_close(one[0, :, 3, 5], want, atol=1e-7, rtol=0)
    assert torch.equal(one, one[:1, :, :1, :1].expand_as(one))
    delta = (CFG.depth_max - CFG.depth_min) / CFG.ndepths
    assert CFG.forward_interval == pytest.approx(delta, rel=1e-12)
    for stage, prev_scale in ((1, 4), (2, 2)):
        prev = 0.6 + 0.2 * torch.rand(2, H // prev_scale, W // prev_scale,
                                      generator=gen)
        got = port._hypotheses(stage, prev, 2, H, W, "cpu")
        d, r = CFG.stage_planes[stage], CFG.interval_ratios[stage]
        s = (4, 2, 1)[stage]
        cur = F.interpolate(prev[:, None], (H, W), mode="bilinear",
                            align_corners=False)[:, 0]
        i = torch.arange(d, dtype=torch.float32).view(1, d, 1, 1)
        lo, hi = cur - d / 2 * r * delta, cur + d / 2 * r * delta
        formula = lo[:, None] + i * ((hi - lo) / (d - 1))[:, None]
        samples = reference.depth_range_samples(cur, d, r * delta, (2, H, W))
        published = F.interpolate(samples[:, None], [d, H // s, W // s],
                                  mode="trilinear",
                                  align_corners=False)[:, 0]
        assert got.shape == (2, d, H // s, W // s)
        torch.testing.assert_close(got, published, atol=2e-7, rtol=0)
        if s == 1:
            torch.testing.assert_close(got, formula, atol=2e-7, rtol=0)
            torch.testing.assert_close(got.mean(1), cur, atol=2e-7, rtol=0)


def test_softargmin_of_planes_is_unchanged():
    """The [N, D] path of softargmin_depth, bit for bit its form before
    per-pixel hypotheses (hybrid_depth_decoder.py:33-38), in float32 and
    on bfloat16 logits."""
    gen = torch.Generator().manual_seed(1)
    logits = torch.randn(2, 8, 6, 7, generator=gen)
    planes = torch.linspace(0.5, 8.0, 8)[None].expand(2, 8)
    for x in (logits, logits.bfloat16()):
        probs = torch.softmax(x.float(), 1)
        depth, pmax = decoder.softargmin_depth(x, planes)
        assert torch.equal(depth, torch.einsum("ndhw,nd->nhw", probs,
                                               planes.float()))
        assert torch.equal(pmax, probs.amax(1))
    per_pixel = planes[:, :, None, None].expand(2, 8, 6, 7)
    depth, _ = decoder.softargmin_depth(logits, per_pixel)
    torch.testing.assert_close(depth, decoder.softargmin_depth(
        logits, planes)[0], atol=1e-6, rtol=0)


def test_photometric_confidence_is_the_published_pooling():
    """The 4 planes idx-1 .. idx+2 against the published 4 x avg_pool3d,
    with pixels whose mass sits on the first and the last plane (the
    zeros outside)."""
    gen = torch.Generator().manual_seed(6)
    logits = 4 * torch.randn(2, 8, 5, 6, generator=gen)
    logits[0, 0, 0, 0] = logits[1, 7, 4, 5] = 60.0
    probs = torch.softmax(logits, 1)
    conf, idx = photometric_confidence(probs)
    want_conf, want_idx = reference.photometric_confidence(probs)
    assert idx[0, 0, 0] == 0 and idx[1, 4, 5] == 7
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(conf, want_conf, atol=1e-7, rtol=0)


def test_spans_and_counters(models, views):
    port, _ = models
    runner = MVSRunner(port, device="cpu")
    before = trace.counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        runner.run_view(*views)
    names = [e.name for e in prof.events()]
    assert names.count("estdepth::step") == 1
    assert names.count("estdepth::mvs_features") == 1
    for span in ("mvs_cost_volume", "mvs_regularization", "mvs_regression"):
        assert names.count(f"estdepth::{span}") == 3, span
    assert names.count("estdepth::plane_sweep_sample") == 3 * 2
    assert names.count("estdepth::view_variance") == 3
    after = trace.counts()
    grow = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("mvs.targets", "mvs.feature_views")}
    assert grow == {"mvs.targets": 1, "mvs.feature_views": 3}


def test_config_refuses_what_the_model_does_not_compute():
    with pytest.raises(ValueError, match="float32"):
        CascadeConfig(compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="multiples of 8"):
        CascadeConfig(stage_planes=(48, 32, 4))
    with pytest.raises(ValueError, match="divide by 32"):
        CascadeMVSNet(CFG)(torch.zeros(1, 2, 48, 64, 3, dtype=torch.uint8),
                           torch.eye(4).expand(1, 2, 4, 4),
                           torch.eye(3)[None])
