"""TransMVSNet in the port (models/transmvsnet.py, eval/mvs.py) against the
benchmark's plain reference (portbench/reference/transmvsnet.py), its
parts against the published forms they follow, and the cascade it shares
with CasMVSNet (models/casmvsnet.py:MVSCascade), whose output the split
must leave as it was.

The small size is 3 views at 64x96 with the published widths and 8/8/8
planes, on seeded random weights with randomized BatchNorm statistics
and scales. The JAX package has no TransMVSNet: the reference is the
plain float32 forward written from the published code.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from estdepth_tpu_torch.config import CascadeConfig
from estdepth_tpu_torch.eval.mvs import MVSRunner
from estdepth_tpu_torch.models import casmvsnet, transmvsnet
from estdepth_tpu_torch.models.decoder import expected_depth
from estdepth_tpu_torch.models.estdepth import measured_conv_plans
from estdepth_tpu_torch.models.transmvsnet import TransMVSNet
from estdepth_tpu_torch.ops import geometry
from estdepth_tpu_torch.utils import trace
from portbench.harness.scenes import Path, make_scenes
from portbench.reference import casmvsnet as cas_reference
from portbench.reference import transmvsnet as reference
from test_torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W = 64, 96
CFG = CascadeConfig(stage_planes=(8, 8, 8))
VIEWS = [2, 1, 3]  # the reference and its two nearest views


def _randomize_norms(model: nn.Module, seed: int) -> None:
    """BatchNorm statistics and scales, and LayerNorm scales, away from
    the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
            elif isinstance(m, nn.LayerNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)


def _reference_of(port: TransMVSNet) -> reference.TransMVSNet:
    ref = reference.TransMVSNet(
        port.cfg.stage_planes, port.cfg.interval_ratios, port.cfg.ndepths,
        port.cfg.depth_min, port.cfg.depth_interval)
    ref.load_state_dict(port.state_dict(), strict=True)
    return ref.eval()


@pytest.fixture(scope="module")
def models():
    """The port's model and the reference on one state_dict."""
    port = TransMVSNet(CFG, seed=3)
    _randomize_norms(port, 4)
    return port, _reference_of(port)


@pytest.fixture(scope="module")
def views():
    """A 3-view request of a synthetic scan (the benchmark's camera path,
    DTU's field of view at 96 wide), with a small pitch and lift so that
    no row projects exactly onto the border."""
    path = Path(height=H, width=W, frames=4, step_x=0.03, step_z=-0.0045,
                yaw_per_frame=0.002, plane_offset=(0.6, 0.75),
                focal=2892.33 * W / 1600)
    scene = make_scenes(path, 1, 5, torch.device("cpu"))[0]
    poses = scene.poses[VIEWS].copy()
    poses[1:, 1, 3] += np.float32(0.004)
    c, s = np.cos(0.003), np.sin(0.003)
    poses[2, :3, :3] = poses[2, :3, :3] @ np.array(
        [[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    return (torch.from_numpy(scene.frames[VIEWS])[None],
            torch.from_numpy(poses)[None],
            torch.from_numpy(scene.intr)[None])


def test_runner_follows_the_reference(models, views):
    """Each stage against the reference started from the port's previous
    stage (the output check's form). Where both argmaxes agree the depth
    is the same hypothesis, bit for bit at stages 2 and 3 (the same ops on
    the same depth) and within an ulp of 0.93 m at stage 1 (a linspace
    against the published trilinear resize): 1.2e-7 m. The argmax flips
    only where the top two probabilities lie within rounding of each
    other; the two differ in the order of sums (batched views, the
    deformable taps through grid_sample against nine explicit gathers,
    the channels-last correlation's mean), which moves a probability by
    ~6e-6 here, so at most 8 of the 8064 pixels may flip, and the
    confidence is held to 1e-4 of a probability where they agree."""
    port, ref = models
    depth, confidence = MVSRunner(port, device="cpu").run_view(*views)
    got = MVSRunner(port, return_all=True, device="cpu").run_view(*views)
    with torch.inference_mode():
        want = ref(*views, prev_depths=got["stage_depths"][:2])
    assert torch.equal(got["depth"], depth)
    assert torch.equal(got["confidence"], confidence)
    flips = 0
    for k in range(3):
        s = (4, 2, 1)[k]
        g, r = got["stage_depths"][k], want["stage_depths"][k]
        gi, ri = got["stage_indices"][k], want["stage_indices"][k]
        assert g.shape == r.shape == gi.shape == (1, H // s, W // s)
        same = gi == ri
        flips += int((~same).sum())
        torch.testing.assert_close(g[same], r[same], atol=1.2e-7, rtol=0)
    assert flips <= 8
    assert torch.equal(got["index"], got["stage_indices"][-1])
    same = got["index"] == want["index"]
    torch.testing.assert_close(confidence[same], want["confidence"][same],
                               atol=1e-4, rtol=0)
    assert depth.min() > CFG.depth_min and depth.max() < CFG.depth_max
    assert confidence.min() > 1 / 8 and confidence.max() <= 1


def _layers(seed: int):
    """A port FMT layer and the reference's LoFTR layer on one state."""
    gen = torch.Generator().manual_seed(seed)
    port = transmvsnet.EncoderLayer()
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen)
                    + (1.0 if p.dim() == 1 else 0.0))
    ref = reference.EncoderLayer()
    ref.load_state_dict(port.state_dict(), strict=True)
    return port, ref


def test_fmt_layer_is_loftrs_einsum_form():
    """A self layer (source = x) and a cross layer (source another map's
    tokens) against LoFTR's LoFTREncoderLayer and LinearAttention. The
    port makes KV in row blocks (`attention_memory`), so the S-long sums
    add in another order: within 1e-6 of the output's scale. Two sources
    attending to one reference through its keys and values made once
    (`EncoderLayer.memory`, repeated a source) likewise."""
    port, ref = _layers(7)
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(1, 300, 32, generator=gen)
    src = torch.randn(2, 300, 32, generator=gen)
    with torch.inference_mode():
        want = ref(x, x)
        tol = dict(atol=1e-6 * float(want.abs().max()), rtol=0)
        torch.testing.assert_close(port(x), want, **tol)
        torch.testing.assert_close(port(src[:1], port.memory(x)),
                                   ref(src[:1], x), **tol)
        kv, k_sum, length = port.memory(x)
        shared = port(src, (kv.repeat_interleave(2, 0),
                            k_sum.repeat_interleave(2, 0), length))
        for i in range(2):
            torch.testing.assert_close(shared[i:i + 1],
                                       ref(src[i:i + 1], x), **tol)


def test_attention_memory_in_row_blocks_is_loftrs_kv():
    """KV of 115,200 tokens (the DTU stage-1 map) summed in 256 row
    blocks: no farther from the float64 sum than LoFTR's einsum in
    float32 is (4.4e-9 against 5.4e-9 here), and within 1e-6 of it
    relative to its scale; sum_s phi(K_s) and S as LoFTR has them."""
    gen = torch.Generator().manual_seed(3)
    k = torch.randn(2, 115200, 8, 4, generator=gen)
    v = torch.randn(2, 115200, 8, 4, generator=gen)
    kv, k_sum, length = transmvsnet.attention_memory(k, v)
    phi = F.elu(k) + 1
    want = torch.einsum("nshd,nshv->nhdv", phi, v / 115200)
    exact = torch.einsum("nshd,nshv->nhdv", phi.double(),
                         v.double() / 115200)
    assert length == 115200 and kv.shape == (2, 8, 4, 4)
    assert torch.equal(k_sum, phi.sum(1))
    assert (kv.double() - exact).abs().max() <= 1.5 * (
        want.double() - exact).abs().max()
    torch.testing.assert_close(kv, want, atol=1e-6 * float(
        want.abs().max()), rtol=0)


def test_fmt_runs_the_published_layer_order(models):
    """The port's FMT with pathway, batched over views, against the
    reference's view-by-view FMT_with_pathway: the reference view through
    the self layers, each source through all 8 with cross layer 2j + 1
    attending to the reference's output j. Same operations, other batch
    sizes: within 1e-5 of the maps' scale."""
    port, ref = models
    gen = torch.Generator().manual_seed(9)
    v, c = 3, transmvsnet.BASE_CHANNELS
    feats = [torch.randn(v, 4 * c, 8, 12, generator=gen),
             torch.randn(v, 2 * c, 16, 24, generator=gen),
             torch.randn(v, c, 32, 48, generator=gen)]
    before = trace.counts().get("mvs.fmt_tokens", 0)
    with torch.inference_mode():
        got = port.fmt([f.clone() for f in feats], 1, v)
        want = ref.fmt([[f[i:i + 1].clone() for f in feats]
                        for i in range(v)])
    assert trace.counts()["mvs.fmt_tokens"] - before == 8 * 12 * (4 + 16)
    for k in range(3):
        w = torch.cat([want[i][k] for i in range(v)])
        assert got[k].shape == w.shape
        torch.testing.assert_close(got[k], w, atol=1e-5 * float(
            w.abs().max()), rtol=0)


def _deform_pair(c: int, seed: int, offset_scale: float):
    gen = torch.Generator().manual_seed(seed)
    port = transmvsnet.DeformConv2d(c)
    with torch.no_grad():
        port.weight.copy_(torch.randn(port.weight.shape, generator=gen) / 9)
        port.offset_mask.weight.copy_(offset_scale * torch.randn(
            port.offset_mask.weight.shape, generator=gen))
        port.offset_mask.bias.copy_(torch.randn(27, generator=gen))
    ref = reference.DeformConv2d(c)
    ref.load_state_dict(port.state_dict(), strict=True)
    x = torch.randn(2, c, 13, 17, generator=gen)
    return port, ref, x


@pytest.mark.parametrize("c", [8, 32])
def test_deformable_conv_is_nine_explicit_taps(c):
    """Offsets of several pixels (taps inside, straddling the border and
    outside the map) against the reference's nine explicit bilinear taps,
    each corner outside counting zero. grid_sample's normalised
    coordinates round the sample position by ~1e-6 px: within 1e-5 of the
    output's scale."""
    port, ref, x = _deform_pair(c, c, 0.6)
    with torch.inference_mode():
        offset = port.offset_mask(x)[:, :18]
        got, want = port(x), ref(x)
    assert float(offset.abs().max()) > 2  # some taps leave the map
    torch.testing.assert_close(got, want, atol=1e-5 * float(
        want.abs().max()), rtol=0)


def test_deformable_conv_at_zero_offsets_is_the_convolution():
    """Zero offsets and a mask of one (its logits at 40: sigmoid rounds to
    1 in float32): both the port's and the reference's deformable
    convolution are F.conv2d with padding 1, up to the order of the 9 C
    products' sum (1e-6 of the output's scale)."""
    port, ref, x = _deform_pair(16, 2, 0.0)
    with torch.no_grad():
        port.offset_mask.bias.copy_(torch.tensor([0.0] * 18 + [40.0] * 9))
        ref.offset_mask.bias.copy_(port.offset_mask.bias)
    with torch.inference_mode():
        want = F.conv2d(x, port.weight, padding=1)
        for m in (port, ref):
            torch.testing.assert_close(m(x), want, atol=1e-6 * float(
                want.abs().max()), rtol=0)


def _stage(h, w, c, d, seed):
    """Features [1, 3, h, w, C], projections [1, 3, 4, 4] of a reference
    and two sources 3 cm apart, per-pixel hypotheses [1, D, h, w]."""
    gen = torch.Generator().manual_seed(seed)
    f = 2892.33 * w / 1600
    k = torch.tensor([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1]])
    poses = torch.eye(4).repeat(3, 1, 1)
    poses[1, 0, 3], poses[2, 0, 3] = 0.03, -0.03
    poses[1:, 1, 3] = 0.004
    proj = geometry.camera_projection(k.expand(3, 3, 3), poses)[None]
    maps = torch.randn(1, 3, h, w, c, generator=gen)
    hyp = (0.6 + 0.1 * torch.rand(1, 1, h, w, generator=gen)
           + torch.linspace(-0.05, 0.05, d).view(1, d, 1, 1))
    return maps, proj, hyp


def test_correlation_volume_and_view_weights(models):
    """Stage 1: each source's correlation, the mean over channels of its
    swept volume times the reference, its PixelwiseNet weight (the max
    over D of the sigmoid), and the weighted mean sum_i w_i c_i /
    (1e-5 + sum_i w_i), against the reference's homo_warping and the
    published loop (1e-6: the sweep's gather against grid_sample, the
    channels-last mean). Stage 2 reuses the weights upsampled x2
    (nearest)."""
    port, ref = models
    maps, proj, hyp = _stage(12, 16, 32, 8, 0)
    with torch.inference_mode():
        vol, weights = port._cost_volume(0, maps, proj, hyp, None)
        ref_vol = maps[:, 0].permute(0, 3, 1, 2)[:, :, None]
        corr = [(cas_reference.homo_warping(
            maps[:, i].permute(0, 3, 1, 2), proj[:, i], proj[:, 0], hyp)
            * ref_vol).mean(1, keepdim=True) for i in (1, 2)]
        w = [ref.pixel_wise_net(c) for c in corr]
        want = (corr[0] * w[0][:, None] + corr[1] * w[1][:, None]) / (
            1e-5 + w[0][:, None] + w[1][:, None])
        assert vol.shape == (1, 1, 8, 12, 16)
        assert weights.shape == (1, 2, 12, 16)
        assert float(weights.min()) > 0 and float(weights.max()) < 1
        torch.testing.assert_close(weights, torch.cat(w, 1), atol=1e-6,
                                   rtol=0)
        torch.testing.assert_close(vol, want, atol=1e-6, rtol=0)
        maps2, proj2, hyp2 = _stage(24, 32, 16, 8, 1)
        vol2, weights2 = port._cost_volume(1, maps2, proj2, hyp2, weights)
    assert torch.equal(weights2, weights.repeat_interleave(
        2, 2).repeat_interleave(2, 3))
    with torch.inference_mode():
        vol_own = port._cost_volume(1, maps2, proj2, hyp2, None)[0]
    assert not torch.equal(vol2, vol_own)


def test_argmax_readout_on_a_planted_volume():
    """The hypothesis at the argmax of the softmax, the first of equal
    maxima, its probability the confidence, at every stage; "index" and
    "confidence" at the last."""
    gen = torch.Generator().manual_seed(4)
    logits = torch.randn(2, 8, 5, 6, generator=gen)
    logits[0, :, 1, 2] = 0.0
    logits[0, 5, 1, 2] = logits[0, 3, 1, 2] = 4.0  # a tie: plane 3 wins
    logits[1, :, 4, 5] = -3.0
    logits[1, 7, 4, 5] = 3.0
    hyp = 0.5 + torch.rand(2, 8, 5, 6, generator=gen).cumsum(1)
    out = {}
    depth = TransMVSNet._readout(None, logits, hyp, False, out)
    assert set(out) == {"stage_indices"}
    depth = TransMVSNet._readout(None, logits, hyp, True, out)
    probs = torch.softmax(logits, 1)
    index = out["index"]
    assert out["stage_indices"][1] is index
    assert index[0, 1, 2] == 3 and index[1, 4, 5] == 7
    assert torch.equal(index, reference.torch.argmax(probs, 1))
    assert torch.equal(depth, reference.depth_wta(probs, hyp))
    assert torch.equal(out["confidence"], probs.amax(1))
    assert torch.equal(depth[0, 1, 2], hyp[0, 3, 1, 2])


def test_runner_takes_either_model(views):
    """MVSRunner.run_view drives both cascades: (depth, confidence) of the
    final stage, or with `return_all` the whole dict, the same maps."""
    for model in (casmvsnet.CascadeMVSNet(CFG, seed=1),
                  TransMVSNet(CFG, seed=1)):
        depth, conf = MVSRunner(model, device="cpu").run_view(*views)
        out = MVSRunner(model, return_all=True, device="cpu").run_view(
            *views)
        assert {"depth", "confidence", "index", "stage_depths"} <= set(out)
        assert torch.equal(out["depth"], depth)
        assert torch.equal(out["confidence"], conf)
        assert depth.shape == conf.shape == (1, H, W)
        assert len(out["stage_depths"]) == 3


def test_spans_and_counters(models, views):
    port, _ = models
    runner = MVSRunner(port, device="cpu")
    before = trace.counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        runner.run_view(*views)
    names = [e.name for e in prof.events()]
    for span in ("step", "mvs_features", "mvs_arf", "mvs_fmt"):
        assert names.count(f"estdepth::{span}") == 1, span
    for span in ("mvs_cost_volume", "mvs_regularization", "mvs_regression"):
        assert names.count(f"estdepth::{span}") == 3, span
    assert names.count("estdepth::plane_sweep_sample") == 3 * 2
    assert names.count("estdepth::view_correlation") == 3 * 2
    assert names.count("estdepth::view_variance") == 0
    after = trace.counts()
    grow = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("mvs.targets", "mvs.feature_views", "mvs.fmt_tokens")}
    assert grow == {"mvs.targets": 1, "mvs.feature_views": 3,
                    "mvs.fmt_tokens": 16 * 24 * (4 + 8 * 2)}


def test_refuses_what_it_does_not_compute():
    model = TransMVSNet(CFG)
    poses, intr = torch.eye(4).expand(1, 2, 4, 4), torch.eye(3)[None]
    with pytest.raises(ValueError, match="source view"):
        model(torch.zeros(1, 1, 64, 96, 3, dtype=torch.uint8),
              poses[:, :1], intr)
    with pytest.raises(ValueError, match="TransMVSNet takes sides that "
                                         "divide by 32"):
        model(torch.zeros(1, 2, 48, 64, 3, dtype=torch.uint8), poses, intr)
    with pytest.raises(ValueError, match="float32"):
        TransMVSNet(CascadeConfig(compute_dtype="bfloat16"))


def _parent_casmvsnet_forward(self, imgs, cam_poses, cam_intr):
    """CascadeMVSNet.forward before the cascade was shared with
    TransMVSNet, verbatim."""
    from estdepth_tpu_torch.models.casmvsnet import (
        STAGE_SCALES, camera_projection, photometric_confidence,
        scale_intrinsics,
    )

    b, v, height, width, _ = imgs.shape
    with trace.span("mvs_features"):
        x = (imgs.reshape(b * v, height, width, 3).float() / 255.0)
        feats = self.feature(x.permute(0, 3, 1, 2).contiguous())
    poses = cam_poses.reshape(b * v, 4, 4)
    depth, stage_depths = None, []
    for k, f in enumerate(feats):
        _, c, h, w = f.shape
        with trace.span("mvs_cost_volume"):
            k_s = scale_intrinsics(cam_intr, 1.0 / STAGE_SCALES[k])
            proj = camera_projection(
                k_s[:, None].expand(b, v, 3, 3).reshape(b * v, 3, 3),
                poses).reshape(b, v, 4, 4)
            hyp = self._hypotheses(k, depth, b, height, width,
                                   imgs.device)
            maps = f.permute(0, 2, 3, 1).contiguous().view(
                b, v, h, w, c)
            var = self._variance(maps, proj, hyp)
        with trace.span("mvs_regularization"), measured_conv_plans():
            logits = self.cost_regularization[k](var)[:, 0]
        del var
        with trace.span("mvs_regression"):
            probs = torch.softmax(logits, 1)
            depth = expected_depth(probs, hyp)
            if k == len(feats) - 1:
                confidence, index = photometric_confidence(probs)
        stage_depths.append(depth)
    return {"depth": depth, "confidence": confidence, "index": index,
            "stage_depths": stage_depths}


def test_casmvsnet_output_is_unchanged_by_the_shared_cascade(views):
    """CascadeMVSNet through the shared `MVSCascade.forward` against its
    forward before the split, on the same module: bit for bit, every
    output and every stage."""
    model = casmvsnet.CascadeMVSNet(CascadeConfig(stage_planes=(16, 8, 8)),
                                    seed=3)
    _randomize_norms(model, 4)
    with torch.inference_mode():
        got = model(*views)
        want = _parent_casmvsnet_forward(model, *views)
    assert set(got) == set(want)
    for key in ("depth", "confidence", "index"):
        assert torch.equal(got[key], want[key]), key
    for g, w in zip(got["stage_depths"], want["stage_depths"], strict=True):
        assert torch.equal(g, w)
