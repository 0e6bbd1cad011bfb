"""CasMVSNet: cascade cost volumes for multi-view stereo (Gu et al., CVPR
2020, arXiv:1912.06378; cascade-stereo CasMVSNet/models/cas_mvsnet.py and
module.py), at the published widths: FeatureNet(base_channels=8,
num_stage=3, arch_mode="fpn"), one CostRegNet(base_channels=8) a stage
(share_cr False) and the DTU evaluation setting of `config.CascadeConfig`.

Given V views [B, V, H, W, 3] in 0..255 (view 0 the reference, the others
its sources), cam-to-world poses [B, V, 4, 4] and full-resolution
intrinsics [B, 3, 3], the network predicts the reference view's depth in
three stages, at 1/4, 1/2 and full resolution:

- the FPN feature net gives each view 32, 16 and 8 channels at the three
  scales (`mvs_features`);
- stage k's D_k depth hypotheses are per pixel, [B, D_k, h_k, w_k]: stage
  1 spreads its planes over the scan's range, stages 2 and 3 centre theirs
  on the previous stage's depth, detached, at `interval_ratios[k]` forward
  intervals apart (`_hypotheses`, the published get_depth_range_samples
  and the trilinear resize after it, align_corners False, whose
  arithmetic the benchmark's reference repeats op for op);
- each source view's features are swept to the hypotheses
  (ops/warp.plane_sweep_warp: kernel 1 on the card), and the variance
  sum v^2 / V - (sum v / V)^2 over the reference and the warped views is
  summed one view at a time, in the published DepthNet's order, by one op
  (ops/cuda/view_variance: on the card a kernel that reads each swept
  volume once; `mvs_cost_volume`, one span a stage);
- the stage's 3D U-Net (`CostRegNet`, `mvs_regularization`) turns the
  [B, C, D, h, w] variance into one logit a hypothesis, and the softmax
  over D gives the stage's depth sum_i p_i d_i (`mvs_regression`).

The final stage also gives the photometric confidence: the probability of
the 4 planes idx-1 .. idx+2 around idx = floor(sum_i i p_i), zeros
outside (the published 4-plane avg_pool3d), computed for that stage only,
whose confidence the network returns. The swept volumes are
channels-last, [B, D, h, w, C], the sweep's layout; the variance op
writes the U-Net's NCDHW. Float32 with TF32 off only
(config.set_fp32_numerics).

Counters (utils/trace.py): `mvs.targets` (reference depth maps) and
`mvs.feature_views` (views through the feature net). Host waits: the
first stage's depth range, two scalars made on the host, is copied
inside `host_wait.constant`, and each stage's projections wait as
ops/geometry.py says (`host_wait.inverse`, `host_wait.constant`).

`MVSCascade` is the cascade that CasMVSNet and TransMVSNet
(models/transmvsnet.py) share: the refusals, the counters, the feature
net's span, the per-stage loop with its projections, hypotheses and
spans, and the U-Net call under cuDNN's measured plans. A model supplies
`feature`, `cost_regularization` and three steps: `_refine` (what follows
the feature net; nothing here), `_cost_volume` (the variance here) and
`_readout` (soft-argmin and the pooled confidence here).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from estdepth_tpu_torch.config import CascadeConfig
from estdepth_tpu_torch.models.decoder import expected_depth
from estdepth_tpu_torch.models.estdepth import measured_conv_plans
from estdepth_tpu_torch.models.layers import (
    Conv2d, Conv3d, conv_bn, deconv_bn, init_weights, upsample_nearest,
)
from estdepth_tpu_torch.ops.geometry import (
    camera_projection, scale_intrinsics,
)
from estdepth_tpu_torch.ops.cuda.view_variance import view_variance
from estdepth_tpu_torch.ops.warp import plane_sweep_warp
from estdepth_tpu_torch.utils import trace

BASE_CHANNELS = 8  # FeatureNet(base_channels=8), CostRegNet(base_channels=8)
STAGE_SCALES = (4, 2, 1)  # each stage's downsampling of the image
# the image's side must divide by this: stage 1 at 1/4, then the U-Net
# halves h and w three times
SIZE_MULTIPLE = 32


class FeatureNet(nn.Module):
    """The published FPN feature net: 8, 16 and 32 channels at full, 1/2
    and 1/4 resolution, then 32 channels at 1/4 (`out1`), 16 at 1/2
    (`out2`) and 8 at full resolution (`out3`)."""

    def __init__(self, c: int = BASE_CHANNELS):
        super().__init__()
        self.conv0 = nn.Sequential(conv_bn(3, c, 3, act="relu"),
                                   conv_bn(c, c, 3, act="relu"))
        self.conv1 = nn.Sequential(conv_bn(c, 2 * c, 5, 2, act="relu"),
                                   conv_bn(2 * c, 2 * c, 3, act="relu"),
                                   conv_bn(2 * c, 2 * c, 3, act="relu"))
        self.conv2 = nn.Sequential(conv_bn(2 * c, 4 * c, 5, 2, act="relu"),
                                   conv_bn(4 * c, 4 * c, 3, act="relu"),
                                   conv_bn(4 * c, 4 * c, 3, act="relu"))
        self.out1 = Conv2d(4 * c, 4 * c, 1, bias=False)
        self.inner1 = Conv2d(2 * c, 4 * c, 1, bias=True)
        self.inner2 = Conv2d(c, 4 * c, 1, bias=True)
        self.out2 = Conv2d(4 * c, 2 * c, 3, padding=1, bias=False)
        self.out3 = Conv2d(4 * c, c, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor):
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        out1 = self.out1(conv2)
        intra = upsample_nearest(conv2) + self.inner1(conv1)
        out2 = self.out2(intra)
        intra = upsample_nearest(intra) + self.inner2(conv0)
        return out1, out2, self.out3(intra)


class CostRegNet(nn.Module):
    """The published 3D U-Net: 8, 16, 32 and 64 channels at full, 1/2, 1/4
    and 1/8 of (D, h, w), back up by transposed convolutions with the
    encoder's maps added, and one logit a voxel (`prob`)."""

    def __init__(self, cin: int, c: int = BASE_CHANNELS):
        super().__init__()
        self.conv0 = conv_bn(cin, c, 3, dims=3, act="relu")
        self.conv1 = conv_bn(c, 2 * c, 3, 2, dims=3, act="relu")
        self.conv2 = conv_bn(2 * c, 2 * c, 3, dims=3, act="relu")
        self.conv3 = conv_bn(2 * c, 4 * c, 3, 2, dims=3, act="relu")
        self.conv4 = conv_bn(4 * c, 4 * c, 3, dims=3, act="relu")
        self.conv5 = conv_bn(4 * c, 8 * c, 3, 2, dims=3, act="relu")
        self.conv6 = conv_bn(8 * c, 8 * c, 3, dims=3, act="relu")
        self.conv7 = deconv_bn(8 * c, 4 * c)
        self.conv9 = deconv_bn(4 * c, 2 * c)
        self.conv11 = deconv_bn(2 * c, c)
        self.prob = Conv3d(c, 1, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return self.prob(x)


def photometric_confidence(probs: torch.Tensor):
    """(confidence, idx) of plane probabilities [B, D, H, W]: idx =
    floor(sum_i i p_i) clamped to [0, D-1], and the sum of the
    probabilities of planes idx-1 .. idx+2, zeros outside, added in that
    order (the published 4 x avg_pool3d over a (1, 2)-padded volume)."""
    d = probs.shape[1]
    planes = torch.arange(d, dtype=probs.dtype, device=probs.device)
    idx = expected_depth(probs, planes.view(1, d, 1, 1)).long()
    idx = idx.clamp(0, d - 1)
    padded = F.pad(probs, (0, 0, 0, 0, 1, 2))  # plane j at j + 1
    taps = torch.arange(4, device=probs.device).view(1, 4, 1, 1)
    window = padded.gather(1, idx[:, None] + taps)
    return window[:, 0] + window[:, 1] + window[:, 2] + window[:, 3], idx


class MVSCascade(nn.Module):
    """The three-stage cascade of per-pixel plane sweeps. Subclasses set
    `feature` (FPN maps at 1/4, 1/2 and full resolution), one
    `cost_regularization[k]` a stage (a volume [B, C, D, h, w] -> logits
    [B, 1, D, h, w]) and the steps `_refine`, `_cost_volume` and
    `_readout`; `cfg` is a `CascadeConfig`."""

    def __init__(self, cfg: CascadeConfig):
        super().__init__()
        self.cfg = cfg

    def _hypotheses(self, stage: int, prev, batch: int, height: int,
                    width: int, device) -> torch.Tensor:
        """Stage `stage`'s depth hypotheses [B, D, h, w] at its resolution,
        from the previous stage's depth [B, h', w'] (None at stage 1)."""
        cfg = self.cfg
        d = cfg.stage_planes[stage]
        scale = STAGE_SCALES[stage]
        size = (height // scale, width // scale)
        f32 = dict(dtype=torch.float32, device=device)
        steps = torch.arange(d, **f32)
        if prev is None:  # planes over the scan's range, the same a pixel
            with trace.host_wait("constant"):
                lo = torch.tensor(cfg.depth_min, **f32)
                hi = torch.tensor(cfg.depth_max, **f32)
            planes = lo + steps * ((hi - lo) / (d - 1))
            return planes.view(1, d, 1, 1).expand(batch, d, *size)
        cur = F.interpolate(prev.detach()[:, None], size=(height, width),
                            mode="bilinear", align_corners=False)[:, 0]
        half = d / 2 * (cfg.interval_ratios[stage] * cfg.forward_interval)
        lo, hi = cur - half, cur + half
        hyp = lo[:, None] + steps.view(1, d, 1, 1) * ((hi - lo) / (d - 1))[
            :, None]
        if size != (height, width):
            hyp = F.interpolate(hyp[:, None], size=(d, *size),
                                mode="trilinear", align_corners=False)[:, 0]
        return hyp

    def _refine(self, feats, batch: int, views: int):
        """The three feature maps [B V, C, h, w] after the feature net."""
        return feats

    def _cost_volume(self, stage: int, maps: torch.Tensor,
                     proj: torch.Tensor, hyp: torch.Tensor, carry):
        """(volume [B, C, D, h, w], carry) of the stage from maps
        [B, V, h, w, C] channels-last, proj [B, V, 4, 4] at the maps'
        scale and hyp [B, D, h, w]; `carry` is what the previous stage's
        call returned (None at stage 1)."""
        raise NotImplementedError

    def _readout(self, logits: torch.Tensor, hyp: torch.Tensor, last: bool,
                 out: dict) -> torch.Tensor:
        """The stage's depth [B, h, w] from its logits [B, D, h, w]; puts
        "confidence" and "index" into `out` at the last stage."""
        raise NotImplementedError

    def forward(self, imgs: torch.Tensor, cam_poses: torch.Tensor,
                cam_intr: torch.Tensor) -> dict:
        """imgs [B, V, H, W, 3] in 0..255 (uint8 or float), view 0 the
        reference; cam_poses [B, V, 4, 4] cam-to-world; cam_intr [B, 3, 3]
        at full resolution. Returns "depth" and "confidence" [B, H, W] of
        the final stage, "index" [B, H, W] (int64) its plane index, and
        "stage_depths", each stage's depth [B, H / s, W / s]."""
        b, v, height, width, _ = imgs.shape
        if v < 2:
            raise ValueError("need a reference view and a source view")
        if height % SIZE_MULTIPLE or width % SIZE_MULTIPLE:
            raise ValueError(f"{height}x{width}: {type(self).__name__} "
                             f"takes sides that divide by {SIZE_MULTIPLE}")
        trace.count("mvs.targets", b)
        trace.count("mvs.feature_views", b * v)
        with trace.span("mvs_features"):
            x = (imgs.reshape(b * v, height, width, 3).float() / 255.0)
            feats = self.feature(x.permute(0, 3, 1, 2).contiguous())
        feats = self._refine(feats, b, v)
        poses = cam_poses.reshape(b * v, 4, 4)
        depth, carry, out = None, None, {"stage_depths": []}
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
                volume, carry = self._cost_volume(k, maps, proj, hyp, carry)
            # on an H100 in float32 the heuristic's plans take 43, 98 and
            # 90 ms for the DTU setting's three CasMVSNet U-Nets, the
            # measured ones 27, 59 and 52; the feature net's are the same
            # either way
            with trace.span("mvs_regularization"), measured_conv_plans():
                logits = self.cost_regularization[k](volume)[:, 0]
            del volume
            with trace.span("mvs_regression"):
                depth = self._readout(logits, hyp, k == len(feats) - 1, out)
            out["stage_depths"].append(depth)
        out["depth"] = depth
        return out


class CascadeMVSNet(MVSCascade):
    def __init__(self, cfg: CascadeConfig = CascadeConfig(), seed: int = 0):
        """Random weights from `seed` by the port's init scheme
        (models/layers.init_weights); load a state_dict for real ones."""
        super().__init__(cfg)
        self.feature = FeatureNet()
        self.cost_regularization = nn.ModuleList(
            [CostRegNet(4 * BASE_CHANNELS >> k) for k in range(3)])
        init_weights(self, torch.Generator().manual_seed(seed))
        self.eval()

    @staticmethod
    def _variance(maps: torch.Tensor, proj: torch.Tensor,
                  hyp: torch.Tensor) -> torch.Tensor:
        """maps [B, V, h, w, C] channels-last, proj [B, V, 4, 4] at the
        maps' scale, hyp [B, D, h, w] -> the variance over the V views
        [B, C, D, h, w]: each source view swept to the hypotheses (kernel
        1), then one `view_variance` over the reference and the V - 1
        swept volumes, all kept until it has read them."""
        warped = [plane_sweep_warp(maps[:, i].contiguous(), proj[:, i],
                                   proj[:, 0], hyp)
                  for i in range(1, maps.shape[1])]
        return view_variance(maps[:, 0].contiguous(), warped)

    def _cost_volume(self, stage, maps, proj, hyp, carry):
        return self._variance(maps, proj, hyp), carry

    def _readout(self, logits, hyp, last, out):
        """Soft-argmin over the hypotheses; the photometric confidence and
        its idx at the last stage."""
        probs = torch.softmax(logits, 1)
        if last:
            out["confidence"], out["index"] = photometric_confidence(probs)
        return expected_depth(probs, hyp)
