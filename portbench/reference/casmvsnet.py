"""Plain PyTorch reference of CasMVSNet (Gu et al., CVPR 2020,
arXiv:1912.06378), float32 only: the forward pass of cascade-stereo's
CasMVSNet/models/cas_mvsnet.py (CascadeMVSNet, DepthNet,
get_depth_range_samples) and module.py (FeatureNet fpn, CostRegNet,
homo_warping, depth_regression) at base channels 8, written from the
published description with no kernel, batching or cache of the port.
Nothing of the port is imported; module and parameter names are the
port's (estdepth_tpu_torch/models/casmvsnet.py), so one state_dict loads
strictly into both.

Departures from the published code, each also in the configuration's
`assumed`:

- the warp samples by the port's rule (reference/model.py:sample_2d,
  `F.grid_sample` with border padding, align_corners=True, times a hard
  zero outside [0, W-1] x [0, H-1]) where homo_warping uses zeros padding
  (which fades an out-of-range corner alone): the two differ only within
  a pixel of the border;
- the projective division adds 1e-8, as the port's (and
  reference/model.py's): the same number for depths over 0.25 m;
- the photometric confidence is computed for the final stage alone, the
  one the network returns;
- the views' features are computed one view at a time, as published, in
  eval mode (BatchNorm on its running statistics).

`forward(..., prev_depths=)` starts stages 2 and 3 from the given
previous-stage depths (the port's, in the output check) in place of its
own. The sample's hard zero outside the map is a step: where the port's
stage-1 depth and this one's differ by rounding, the next stage's sample
coordinates differ by ~1e-4 px, a coordinate within that of the border
lands inside in one and outside in the other, and the two depths then
differ by up to 1e-3 m at a few pixels, more than TF32 moves most maps.
Started from the same depth, each stage's hypotheses, projections and
sample coordinates are the port's bit for bit (the same ops on the same
inputs, the views' projections in one batched call as the port's), so
the masks agree and each stage is held to its own arithmetic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.model import (
    camera_projection, conv_bn, pixel_grid, sample_2d, scale_intrinsics,
)

STAGE_SCALES = (4, 2, 1)


def deconv_bn(cin, cout):
    conv = nn.ConvTranspose3d(cin, cout, 3, 2, 1, 1, bias=False)
    conv.he_init = True
    return nn.Sequential(conv, nn.BatchNorm3d(cout, eps=1e-5),
                         nn.ReLU(inplace=True))


class FeatureNet(nn.Module):
    def __init__(self, c=8):
        super().__init__()
        self.conv0 = nn.Sequential(conv_bn(3, c, 3, act="relu"),
                                   conv_bn(c, c, 3, act="relu"))
        self.conv1 = nn.Sequential(conv_bn(c, 2 * c, 5, 2, act="relu"),
                                   conv_bn(2 * c, 2 * c, 3, act="relu"),
                                   conv_bn(2 * c, 2 * c, 3, act="relu"))
        self.conv2 = nn.Sequential(conv_bn(2 * c, 4 * c, 5, 2, act="relu"),
                                   conv_bn(4 * c, 4 * c, 3, act="relu"),
                                   conv_bn(4 * c, 4 * c, 3, act="relu"))
        self.out1 = nn.Conv2d(4 * c, 4 * c, 1, bias=False)
        self.inner1 = nn.Conv2d(2 * c, 4 * c, 1, bias=True)
        self.inner2 = nn.Conv2d(c, 4 * c, 1, bias=True)
        self.out2 = nn.Conv2d(4 * c, 2 * c, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(4 * c, c, 3, padding=1, bias=False)

    def forward(self, x):
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        stage1 = self.out1(conv2)
        intra = F.interpolate(conv2, scale_factor=2, mode="nearest") + \
            self.inner1(conv1)
        stage2 = self.out2(intra)
        intra = F.interpolate(intra, scale_factor=2, mode="nearest") + \
            self.inner2(conv0)
        return [stage1, stage2, self.out3(intra)]


class CostRegNet(nn.Module):
    def __init__(self, cin, c=8):
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
        self.prob = nn.Conv3d(c, 1, 3, stride=1, padding=1, bias=False)

    def forward(self, x):
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return self.prob(x)


def homo_warping(src_fea, src_proj, ref_proj, depth_values):
    """src_fea [B, C, H, W] at the per-pixel hypotheses [B, D, H, W] of
    the ref camera -> [B, C, D, H, W]."""
    b, c, h, w = src_fea.shape
    d = depth_values.shape[1]
    proj = torch.matmul(src_proj, torch.linalg.inv(ref_proj))
    rot, trans = proj[:, :3, :3], proj[:, :3, 3:4]
    rot_xyz = torch.matmul(rot, pixel_grid(h, w, src_fea.device))
    xyz = rot_xyz[:, :, None] * depth_values.view(b, 1, d, -1)
    xyz = xyz + trans.view(b, 3, 1, 1)
    z = xyz[:, 2] + 1e-8
    x = (xyz[:, 0] / z).reshape(b, -1)
    y = (xyz[:, 1] / z).reshape(b, -1)
    out = sample_2d(src_fea.permute(0, 2, 3, 1), x, y)  # [B, DHW, C]
    return out.transpose(1, 2).reshape(b, c, d, h, w)


def depth_regression(p, depth_values):
    if depth_values.dim() <= 2:
        depth_values = depth_values.view(*depth_values.shape, 1, 1)
    return torch.sum(p * depth_values, 1)


def depth_range_samples(cur_depth, ndepth, interval, shape):
    """get_depth_range_samples: [B, D] planes spread over cur_depth's
    first and last value, or per-pixel hypotheses centred on cur_depth
    [B, H, W], as [B, D, H, W]."""
    steps = torch.arange(0, ndepth, dtype=torch.float32,
                         device=cur_depth.device)
    if cur_depth.dim() == 2:
        lo, hi = cur_depth[:, 0], cur_depth[:, -1]
        samples = lo[:, None] + steps[None] * ((hi - lo) / (ndepth - 1))[
            :, None]
        return samples[..., None, None].repeat(1, 1, shape[1], shape[2])
    lo = cur_depth - ndepth / 2 * interval
    hi = cur_depth + ndepth / 2 * interval
    new_interval = (hi - lo) / (ndepth - 1)
    return lo[:, None] + steps.reshape(1, -1, 1, 1) * new_interval[:, None]


def photometric_confidence(prob_volume):
    d = prob_volume.shape[1]
    sum4 = 4 * F.avg_pool3d(F.pad(prob_volume[:, None], (0, 0, 0, 0, 1, 2)),
                            (4, 1, 1), stride=1, padding=0)[:, 0]
    index = depth_regression(prob_volume, torch.arange(
        d, device=prob_volume.device, dtype=torch.float)).long()
    index = index.clamp(min=0, max=d - 1)
    return torch.gather(sum4, 1, index[:, None])[:, 0], index


class CascadeMVSNet(nn.Module):
    def __init__(self, stage_planes=(48, 32, 8), interval_ratios=(4, 2, 1),
                 ndepths=192, depth_min=0.425, depth_interval=0.00265):
        super().__init__()
        self.stage_planes = tuple(stage_planes)
        self.interval_ratios = tuple(interval_ratios)
        self.ndepths = ndepths
        self.depth_min = depth_min
        self.depth_max = depth_min + (ndepths - 1) * depth_interval
        self.feature = FeatureNet()
        self.cost_regularization = nn.ModuleList(
            [CostRegNet(c) for c in (32, 16, 8)])

    def forward(self, imgs, poses, intr, prev_depths=None):
        """imgs [B, V, H, W, 3] in 0..255, view 0 the reference; poses
        [B, V, 4, 4] cam-to-world; intr [B, 3, 3] at full resolution ->
        {"depth", "confidence", "index", "stage_depths"}. prev_depths:
        the depths [B, H / s, W / s] that stages 2 and 3 start from, in
        place of stages 1 and 2's own."""
        b, v, h, w, _ = imgs.shape
        features = [self.feature(imgs[:, i].permute(0, 3, 1, 2).float()
                                 .contiguous() / 255.0) for i in range(v)]
        interval = (self.depth_max - self.depth_min) / self.ndepths
        depth_values = torch.tensor([[self.depth_min, self.depth_max]],
                                    device=imgs.device).expand(b, 2)
        depth, stage_depths = None, []
        for k, scale in enumerate(STAGE_SCALES):
            d = self.stage_planes[k]
            if depth is None:
                cur = depth_values
            else:
                if prev_depths is not None:
                    depth = prev_depths[k - 1]
                cur = F.interpolate(depth.detach()[:, None], [h, w],
                                    mode="bilinear",
                                    align_corners=False)[:, 0]
            samples = depth_range_samples(
                cur, d, self.interval_ratios[k] * interval, (b, h, w))
            hyp = F.interpolate(samples[:, None], [d, h // scale, w // scale],
                                mode="trilinear", align_corners=False)[:, 0]
            kk = scale_intrinsics(intr, 1.0 / scale)
            projs = camera_projection(
                kk[:, None].expand(b, v, 3, 3).reshape(b * v, 3, 3),
                poses.reshape(b * v, 4, 4)).reshape(b, v, 4, 4).unbind(1)
            ref = features[0][k][:, :, None].repeat(1, 1, d, 1, 1)
            volume_sum, volume_sq_sum = ref, ref ** 2
            del ref
            for i in range(1, v):
                warped = homo_warping(features[i][k], projs[i], projs[0], hyp)
                volume_sum = volume_sum + warped
                volume_sq_sum = volume_sq_sum + warped ** 2
                del warped
            variance = volume_sq_sum.div_(v).sub_(volume_sum.div_(v).pow_(2))
            del volume_sum, volume_sq_sum
            logits = self.cost_regularization[k](variance)[:, 0]
            del variance
            prob = F.softmax(logits, dim=1)
            depth = depth_regression(prob, hyp)
            stage_depths.append(depth)
        confidence, index = photometric_confidence(prob)
        return {"depth": depth, "confidence": confidence, "index": index,
                "stage_depths": stage_depths}
