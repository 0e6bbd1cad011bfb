"""Plain PyTorch reference of TransMVSNet (Ding et al., CVPR 2022,
arXiv:2111.14600), float32 only: the forward pass of
megvii-research/TransMVSNet's models (TransMVSNet, DepthNet, FMT,
FMT_with_pathway, PositionEncodingSuperGule, PixelwiseNet, depth_wta) and
LoFTR's LoFTREncoderLayer and LinearAttention, written from the published
description with no kernel, batching or cache of the port, on the
CasMVSNet pieces of reference/casmvsnet.py (FeatureNet, CostRegNet,
homo_warping, get_depth_range_samples). Nothing of the port is imported;
module and parameter names are the port's
(estdepth_tpu_torch/models/transmvsnet.py), so one state_dict loads
strictly into both.

Departures from the published code, each also in the configuration's
`assumed`:

- ARF is one modulated deformable 3x3 convolution (DCNv2, no bias) on
  each FPN output, its 18 offsets (dy, dx a tap) and 9 sigmoid masks from
  one 3x3 convolution with bias, where the published FeatureNet stacks
  its own DCN layers (not in the repository); the sampling is nine explicit
  bilinear taps, corners outside the map zero, as DCNv2's im2col takes
  them;
- the view weights of stages 2 and 3 are the stage-1 ones upsampled x2
  (nearest) a stage;
- CasMVSNet's reference rules hold: the warp samples by the port's rule,
  the projective division adds 1e-8, the views' features are computed one
  view at a time in eval mode;
- the FMT and the pathway run one view at a time, as published; the
  position encoding is computed for each view, as published.

`forward(..., prev_depths=)` starts stages 2 and 3 from the given
previous-stage depths (the port's, in the output check), as
reference/casmvsnet.py does and for its reason: started from the same
depth, a stage's hypotheses and sample coordinates are the port's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.casmvsnet import (
    STAGE_SCALES, CostRegNet, FeatureNet, depth_range_samples, homo_warping,
)
from portbench.reference.model import (
    camera_projection, conv_bn, scale_intrinsics,
)

LAYER_NAMES = ["self", "cross"] * 4


def bilinear_zeros(x, py, px):
    """x [N, C, H, W] at pixel coordinates py, px [N, K, H', W'] ->
    [N, C, K, H', W']: the four corners' values weighted bilinearly, each
    corner outside the map counting zero."""
    n, c, h, w = x.shape
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    flat = x.reshape(n, c, h * w)
    out = 0
    for dy, dx, wgt in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                        (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
        yi, xi = y0 + dy, x0 + dx
        inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        val = torch.gather(flat, 2, idx.view(n, 1, -1).expand(n, c, -1))
        out = out + val.view(n, c, *py.shape[1:]) * (
            wgt * inside.to(x.dtype))[:, None]
    return out


class DeformConv2d(nn.Conv2d):
    def __init__(self, c):
        super().__init__(c, c, 3, padding=1, bias=False)
        self.offset_mask = nn.Conv2d(c, 27, 3, padding=1, bias=True)

    def forward(self, x):
        n, c, h, w = x.shape
        om = self.offset_mask(x)
        offset, mask = om[:, :18], torch.sigmoid(om[:, 18:])
        ys = torch.arange(h, device=x.device, dtype=x.dtype)
        xs = torch.arange(w, device=x.device, dtype=x.dtype)
        py, px = [], []
        for i in range(3):
            for j in range(3):
                k = 3 * i + j
                py.append(ys.view(1, h, 1) + (i - 1) + offset[:, 2 * k])
                px.append(xs.view(1, 1, w) + (j - 1) + offset[:, 2 * k + 1])
        cols = bilinear_zeros(x, torch.stack(py, 1), torch.stack(px, 1))
        cols = cols * mask[:, None]  # [N, C, 9, H, W]
        return torch.einsum("nckhw,ock->nohw", cols,
                            self.weight.reshape(c, c, 9))


def MLP(channels):
    layers = []
    for i in range(1, len(channels)):
        layers.append(nn.Conv1d(channels[i - 1], channels[i], kernel_size=1,
                                bias=True))
        if i < len(channels) - 1:
            layers.append(nn.BatchNorm1d(channels[i]))
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class KeypointEncoder(nn.Module):
    def __init__(self, feature_dim, layers):
        super().__init__()
        self.encoder = MLP([2] + layers + [feature_dim])

    def forward(self, kpts):
        return self.encoder(kpts.transpose(1, 2))


def normalize_keypoints(kpts, image_shape):
    _, _, height, width = image_shape
    one = kpts.new_tensor(1)
    size = torch.stack([one * width, one * height])[None]
    center = size / 2
    scaling = size.max(1, keepdim=True).values * 0.7
    return (kpts - center[:, None, :]) / scaling[:, None, :]


class PositionEncodingSuperGule(nn.Module):
    def __init__(self, d_model):
        super().__init__()
        self.kenc = KeypointEncoder(d_model, [32, 64, 128])

    def forward(self, x):
        ones = torch.ones((x.shape[2], x.shape[3]), device=x.device)
        y_position = ones.cumsum(0).float().unsqueeze(0)
        x_position = ones.cumsum(1).float().unsqueeze(0)
        xy_position = torch.cat([x_position, y_position]).view(2, -1).permute(
            1, 0).repeat(x.shape[0], 1, 1)
        xy_position_n = normalize_keypoints(xy_position, x.shape)
        return x + self.kenc(xy_position_n).view(x.shape)


def elu_feature_map(x):
    return F.elu(x) + 1


class LinearAttention(nn.Module):
    def __init__(self, eps=1e-6):
        super().__init__()
        self.eps = eps

    def forward(self, queries, keys, values):
        Q = elu_feature_map(queries)
        K = elu_feature_map(keys)
        v_length = values.size(1)
        values = values / v_length
        KV = torch.einsum("nshd,nshv->nhdv", K, values)
        Z = 1 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + self.eps)
        queried_values = torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV,
                                      Z) * v_length
        return queried_values.contiguous()


class EncoderLayer(nn.Module):
    def __init__(self, d_model=32, nhead=8):
        super().__init__()
        self.dim = d_model // nhead
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.attention = LinearAttention()
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(
            nn.Linear(d_model * 2, d_model * 2, bias=False),
            nn.ReLU(True),
            nn.Linear(d_model * 2, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x, source):
        bs = x.size(0)
        query = self.q_proj(x).view(bs, -1, self.nhead, self.dim)
        key = self.k_proj(source).view(bs, -1, self.nhead, self.dim)
        value = self.v_proj(source).view(bs, -1, self.nhead, self.dim)
        message = self.attention(query, key, value)
        message = self.merge(message.view(bs, -1, self.nhead * self.dim))
        message = self.norm1(message)
        message = self.mlp(torch.cat([x, message], dim=2))
        message = self.norm2(message)
        return x + message


def _tokens(x):  # 'n c h w -> n (h w) c'
    return x.flatten(2).transpose(1, 2)


def _maps(x, h):  # 'n (h w) c -> n c h w'
    n, hw, c = x.shape
    return x.transpose(1, 2).reshape(n, c, h, hw // h)


class FMT(nn.Module):
    """FMT_with_pathway: the FMT (`pos_encoding`, `layers`) and the
    pathway's convolutions."""

    def __init__(self, base_channels=8, d_model=32, nhead=8):
        super().__init__()
        self.layers = nn.ModuleList(
            [EncoderLayer(d_model, nhead) for _ in LAYER_NAMES])
        self.pos_encoding = PositionEncodingSuperGule(d_model)
        self.dim_reduction_1 = nn.Conv2d(base_channels * 4,
                                         base_channels * 2, 1, bias=False)
        self.dim_reduction_2 = nn.Conv2d(base_channels * 2,
                                         base_channels * 1, 1, bias=False)
        self.smooth_1 = nn.Conv2d(base_channels * 2, base_channels * 2, 3,
                                  padding=1, bias=False)
        self.smooth_2 = nn.Conv2d(base_channels * 1, base_channels * 1, 3,
                                  padding=1, bias=False)

    def ref(self, ref_feature):
        h = ref_feature.shape[2]
        ref_feature = _tokens(self.pos_encoding(ref_feature))
        ref_feature_list = []
        for layer, name in zip(self.layers, LAYER_NAMES):
            if name == "self":
                ref_feature = layer(ref_feature, ref_feature)
                ref_feature_list.append(_maps(ref_feature, h))
        return ref_feature_list

    def src(self, ref_feature, src_feature):
        h = ref_feature[0].shape[2]
        ref_feature = [_tokens(f) for f in ref_feature]
        src_feature = _tokens(self.pos_encoding(src_feature))
        for i, (layer, name) in enumerate(zip(self.layers, LAYER_NAMES)):
            if name == "self":
                src_feature = layer(src_feature, src_feature)
            else:
                src_feature = layer(src_feature, ref_feature[i // 2])
        return _maps(src_feature, h)

    def _upsample_add(self, x, y):
        _, _, h, w = y.size()
        return F.interpolate(x, size=(h, w), mode="bilinear",
                             align_corners=False) + y

    def forward(self, features):
        """features: one [stage1, stage2, stage3] list a view, view 0 the
        reference; transformed in place."""
        for nview_idx, stages in enumerate(features):
            if nview_idx == 0:
                ref_fea_t_list = self.ref(stages[0].clone())
                stages[0] = ref_fea_t_list[-1]
            else:
                stages[0] = self.src([f.clone() for f in ref_fea_t_list],
                                     stages[0].clone())
            stages[1] = self.smooth_1(self._upsample_add(
                self.dim_reduction_1(stages[0]), stages[1]))
            stages[2] = self.smooth_2(self._upsample_add(
                self.dim_reduction_2(stages[1]), stages[2]))
        return features


class PixelwiseNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = conv_bn(1, 16, 1, dims=3, act="relu")
        self.conv1 = conv_bn(16, 8, 1, dims=3, act="relu")
        self.conv2 = nn.Conv3d(8, 1, kernel_size=1, stride=1, padding=0)
        self.output = nn.Sigmoid()

    def forward(self, x1):
        x1 = self.conv2(self.conv1(self.conv0(x1))).squeeze(1)
        output = self.output(x1)
        return torch.max(output, dim=1, keepdim=True)[0]


def depth_wta(p, depth_values):
    """Winner take all."""
    wta_index_map = torch.argmax(p, dim=1, keepdim=True).type(torch.long)
    return torch.gather(depth_values, 1, wta_index_map).squeeze(1)


class TransMVSNet(nn.Module):
    def __init__(self, stage_planes=(48, 32, 8), interval_ratios=(4, 2, 1),
                 ndepths=192, depth_min=0.425, depth_interval=0.00265):
        super().__init__()
        self.stage_planes = tuple(stage_planes)
        self.interval_ratios = tuple(interval_ratios)
        self.ndepths = ndepths
        self.depth_min = depth_min
        self.depth_max = depth_min + (ndepths - 1) * depth_interval
        self.feature = FeatureNet()
        self.arf = nn.ModuleList([DeformConv2d(c) for c in (32, 16, 8)])
        self.fmt = FMT()
        self.pixel_wise_net = PixelwiseNet()
        self.cost_regularization = nn.ModuleList(
            [CostRegNet(1) for _ in range(3)])

    def forward(self, imgs, poses, intr, prev_depths=None):
        """imgs [B, V, H, W, 3] in 0..255, view 0 the reference; poses
        [B, V, 4, 4] cam-to-world; intr [B, 3, 3] at full resolution ->
        {"depth", "confidence", "index", "stage_depths", "stage_indices"}.
        prev_depths: the depths [B, H / s, W / s] that stages 2 and 3
        start from, in place of stages 1 and 2's own."""
        b, v, h, w, _ = imgs.shape
        features = []
        for i in range(v):
            f = self.feature(imgs[:, i].permute(0, 3, 1, 2).float()
                             .contiguous() / 255.0)
            features.append([arf(x) for arf, x in zip(self.arf, f)])
        features = self.fmt(features)
        interval = (self.depth_max - self.depth_min) / self.ndepths
        depth_values = torch.tensor([[self.depth_min, self.depth_max]],
                                    device=imgs.device).expand(b, 2)
        depth, view_weights = None, None
        stage_depths, stage_indices = [], []
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
                view_weights = F.interpolate(view_weights, scale_factor=2,
                                             mode="nearest")
            samples = depth_range_samples(
                cur, d, self.interval_ratios[k] * interval, (b, h, w))
            hyp = F.interpolate(samples[:, None], [d, h // scale, w // scale],
                                mode="trilinear", align_corners=False)[:, 0]
            kk = scale_intrinsics(intr, 1.0 / scale)
            projs = camera_projection(
                kk[:, None].expand(b, v, 3, 3).reshape(b * v, 3, 3),
                poses.reshape(b * v, 4, 4)).reshape(b, v, 4, 4).unbind(1)
            ref_volume = features[0][k].unsqueeze(2).repeat(1, 1, d, 1, 1)
            correlation_sum, view_weight_sum, made = 0, 1e-5, []
            for i in range(1, v):
                warped = homo_warping(features[i][k], projs[i], projs[0], hyp)
                correlation = (warped * ref_volume).mean(1, keepdim=True)
                del warped
                if view_weights is None:
                    view_weight = self.pixel_wise_net(correlation)
                    made.append(view_weight)
                else:
                    view_weight = view_weights[:, i - 1:i]
                correlation_sum = correlation_sum + \
                    correlation * view_weight.unsqueeze(1)
                view_weight_sum = view_weight_sum + view_weight.unsqueeze(1)
            if view_weights is None:
                view_weights = torch.cat(made, dim=1)
            cost_volume = correlation_sum.div_(view_weight_sum)
            del ref_volume, correlation_sum
            logits = self.cost_regularization[k](cost_volume)[:, 0]
            del cost_volume
            prob = F.softmax(logits, dim=1)
            depth = depth_wta(prob, hyp)
            confidence = torch.max(prob, dim=1)[0]
            stage_depths.append(depth)
            stage_indices.append(torch.argmax(prob, dim=1))
        return {"depth": depth, "confidence": confidence,
                "index": stage_indices[-1], "stage_depths": stage_depths,
                "stage_indices": stage_indices}
