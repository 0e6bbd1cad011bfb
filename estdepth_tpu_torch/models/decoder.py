"""Hybrid depth decoder: semantic U-Net + 3D matching stack + EST fusion
(port of estdepth_tpu/models/decoder.py; reference
hybrid_depth_decoder.py:41-433).

Convolutions run NCHW / NCDHW. The EST fusion follows the JAX layouts:
key/value volumes are warped channels-last [B, D, H, W, C] and the ESTM
memory holds [B, M, D, H, W, C]. The softargmin is taken at cost-volume
resolution and the depth map nearest-upsampled x4 (identical to the
reference's upsample-logits-then-softargmin, since depth hypotheses are
spatially constant). The EST fusion is sequential by default (the
reference's order); `sequential_fusion=False` fuses all targets in one
batched warp and one attention call.

Spans (utils/trace.py): `est_fusion`, around either fusion; inside it
`host_wait.inverse` for each target's pose inverse (ops/geometry.inverse),
besides the frustum warp's own (ops/warp.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from estdepth_tpu_torch.models.est_transformer import EpipolarTransformer
from estdepth_tpu_torch.models.layers import (
    Conv2d, Conv3d, conv_bn, upsample_nearest,
)
from estdepth_tpu_torch.models.memory import ESTMemory
from estdepth_tpu_torch.ops.geometry import inverse
from estdepth_tpu_torch.ops.warp import frustum_warp
from estdepth_tpu_torch.utils import trace


def expected_depth(probs: torch.Tensor,
                   depth_values: torch.Tensor) -> torch.Tensor:
    """sum_i p_i d_i of plane probabilities [N, D, H, W]: depth_values
    [N, D], one depth a plane, or a [N, D, H, W] tensor (or one that
    broadcasts to it) of per-pixel hypotheses, summed over D as
    CasMVSNet's depth_regression does (cas_mvsnet module.py)."""
    if depth_values.dim() == 2:
        return torch.einsum("ndhw,nd->nhw", probs, depth_values.float())
    return (probs * depth_values.float()).sum(1)


def softargmin_depth(logits: torch.Tensor, depth_values: torch.Tensor):
    """Depth expectation and max probability from plane logits
    [N, D, H, W] and depth_values [N, D] or per-pixel [N, D, H, W]
    (hybrid_depth_decoder.py:33-38; expected_depth)."""
    probs = torch.softmax(logits.float(), 1)
    return expected_depth(probs, depth_values), probs.amax(1)


class ConvBlock(nn.Module):
    """convbn 3x3 + ReLU (hybrid_depth_decoder.py:17-30)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = conv_bn(cin, cout, 3, 1, act="relu")

    def forward(self, x):
        return self.conv(x)


def conv_bn_relu_3d(cin: int, cout: int, act: str = "relu") -> nn.Sequential:
    """A one-entry Sequential so names read `<name>.0.{0,1}`."""
    return nn.Sequential(conv_bn(cin, cout, 3, 1, dims=3, act=act))


def stereo_head(channels: int) -> nn.Sequential:
    """convbnrelu_3d(16) + Conv3d(16 -> 1, k1, bias) (decoder :104-112)."""
    return nn.Sequential(conv_bn(channels, channels, 3, 1, dims=3,
                                 act="relu"),
                         Conv3d(channels, 1, 1))


def _head_logits(head: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    return head(x)[:, 0]  # [N, D, H, W]


class DepthHybridDecoder(nn.Module):
    def __init__(self, num_ch_enc, ndepths: int = 64, depth_max: float = 10.0,
                 est_transformer: bool = True, base_channels: int = 32,
                 frustum_mode: str = "plane_mix_exact_z",
                 sequential_fusion: bool = True,
                 use_fused_attention: bool = False,
                 sequential_head_bn: bool = False):
        super().__init__()
        self.sequential_head_bn = sequential_head_bn
        self.ndepths = ndepths
        self.depth_max = depth_max
        self.frustum_mode = frustum_mode
        self.sequential_fusion = sequential_fusion
        enc = num_ch_enc
        nd = ndepths
        self.upconv_4_0 = ConvBlock(enc[4], 256)
        self.upconv_4_1 = ConvBlock(256 + enc[3], 256)
        self.upconv_3_0 = ConvBlock(256, 128)
        self.upconv_3_1 = ConvBlock(128 + enc[2], 128)
        self.upconv_2_0 = ConvBlock(128, nd)
        self.upconv_2_1 = ConvBlock(nd + enc[1], nd)
        self.upconv_1_0 = ConvBlock(2 * nd, 32)
        self.upconv_1_1 = ConvBlock(32 + enc[0], 32)
        self.upconv_0_0 = ConvBlock(32, 16)
        self.upconv_0_1 = ConvBlock(16, 16)
        self.dispconv_1 = Conv2d(32, 1, 3, padding=1)
        self.dispconv_0 = Conv2d(16, 1, 3, padding=1)

        bc = base_channels
        self.dres0 = nn.Sequential(*conv_bn_relu_3d(bc, bc),
                                   *conv_bn_relu_3d(bc, bc))
        self.dres1 = nn.Sequential(*conv_bn_relu_3d(bc, bc),
                                   *conv_bn_relu_3d(bc, bc))
        self.dres2 = conv_bn_relu_3d(bc + 1, bc + 1)
        self.key_layer = conv_bn_relu_3d(bc + 1, bc // 2)
        self.value_layer = conv_bn_relu_3d(bc + 1, bc // 2, act="tanh")
        self.stereo_head0 = stereo_head(bc // 2)
        self.stereo_head1 = stereo_head(bc // 2)
        self.epipolar_transformer = (
            EpipolarTransformer(bc // 2,
                                use_fused_attention=use_fused_attention)
            if est_transformer else None)

    def _semantic_unet(self, feats):
        """Scales 4 -> 2 of the U-Net (decoder :163-184): semantic_vs
        [BN, ndepths, H, W] at 1/4 resolution."""
        x = self.upconv_4_0(feats[4])
        x = self.upconv_4_1(torch.cat([upsample_nearest(x), feats[3]], 1))
        x = self.upconv_3_0(x)
        x = self.upconv_3_1(torch.cat([upsample_nearest(x), feats[2]], 1))
        x = self.upconv_2_0(x)
        return self.upconv_2_1(torch.cat([upsample_nearest(x), feats[1]], 1))

    @trace.spanned("est_fusion")
    def _est_fusion(self, key, value, target_poses, cam_intr, depth_values,
                    depth_min, depth_interval, memory: ESTMemory | None):
        """Every neighbour (in-window + memory) warped into each target's
        frustum in one folded warp, then one attention + GRU call over all
        targets, each attending over the UNFUSED values of its neighbours
        (the double loop at hybrid_depth_decoder.py:229-253, batched).
        key/value [B, num, D, H, W, C] channels-last; returns the fused
        values in the same layout."""
        b, num, d, h, w, c = key.shape
        est = self.epipolar_transformer
        window_valid = torch.ones(b, num, dtype=torch.bool, device=key.device)
        if memory is not None and memory.size > 0:
            all_keys = torch.cat([key, memory.keys.to(key.dtype)], 1)
            all_vals = torch.cat([value, memory.values.to(value.dtype)], 1)
            all_poses = torch.cat([target_poses, memory.poses], 1)
            all_valid = torch.cat([window_valid, memory.valid], 1)
        else:
            all_keys, all_vals = key, value
            all_poses, all_valid = target_poses, window_valid

        s = all_keys.shape[1]
        nn_ = s - 1
        if nn_ == 0:  # single target, no memory: the zero-h GRU fallback
            return est(key[:, 0], value[:, 0])[:, None]
        idx_i = [i for i in range(num) for j in range(s) if j != i]
        idx_j = [j for i in range(num) for j in range(s) if j != i]
        p = len(idx_i)
        rel = torch.matmul(all_poses[:, idx_j],
                           inverse(target_poses[:, idx_i]))
        kv = torch.cat([all_keys[:, idx_j], all_vals[:, idx_j]], -1)
        warped = frustum_warp(
            kv.reshape(b * p, d, h, w, 2 * c), rel.reshape(b * p, 4, 4),
            cam_intr[:, None].expand(b, p, 3, 3).reshape(b * p, 3, 3),
            depth_values[:, None].expand(b, p, d).reshape(b * p, d),
            depth_min, depth_interval, mode=self.frustum_mode,
        )
        # neighbour-leading, targets folded into the batch:
        # [NN, B*num, D, H, W, 2C], a view of the warp's output
        warped = warped.reshape(b * num, nn_, d, h, w, 2 * c).transpose(0, 1)
        valid = all_valid[:, idx_j].reshape(b * num, nn_).t()
        fused = est(key.reshape(b * num, d, h, w, c),
                    value.reshape(b * num, d, h, w, c),
                    warped[..., :c], warped[..., c:], valid)
        return fused.reshape(b, num, d, h, w, c)

    @trace.spanned("est_fusion")
    def _est_fusion_sequential(self, key, value, target_poses, cam_intr,
                               depth_values, depth_min, depth_interval,
                               memory: ESTMemory | None):
        """Targets in order, each attending over the current state of its
        neighbours: in-window neighbours j < i are already fused
        (hybrid_depth_decoder.py:229-254). key/value [B, num, D, H, W, C]
        channels-last; returns the fused values in the same layout."""
        b, num, d, h, w, c = key.shape
        est = self.epipolar_transformer
        window_valid = torch.ones(b, num, dtype=torch.bool, device=key.device)
        if memory is not None and memory.size > 0:
            all_poses = torch.cat([target_poses, memory.poses], 1)
            all_valid = torch.cat([window_valid, memory.valid], 1)
            mem_keys = memory.keys.to(key.dtype)
            mem_vals = memory.values.to(value.dtype)
        else:
            all_poses, all_valid = target_poses, window_valid
            mem_keys = mem_vals = None

        s = all_poses.shape[1]
        if s == 1:
            return est(key[:, 0], value[:, 0])[:, None]

        values = [value[:, i] for i in range(num)]
        keys_all = [key[:, i] for i in range(num)]
        if mem_keys is not None:
            keys_all += [mem_keys[:, m] for m in range(memory.size)]

        for i in range(num):
            nb_idx = [j for j in range(s) if j != i]
            nn_ = len(nb_idx)
            rel = torch.matmul(
                torch.stack([all_poses[:, j] for j in nb_idx], 1),
                inverse(target_poses[:, i])[:, None],
            )  # [B, NN, 4, 4]
            nb_k = torch.stack([keys_all[j] for j in nb_idx], 1)
            nb_v = torch.stack(
                [values[j] if j < num else mem_vals[:, j - num]
                 for j in nb_idx], 1)
            kv = torch.cat([nb_k, nb_v], -1)  # warp keys and values at once
            warped = frustum_warp(
                kv.reshape(b * nn_, d, h, w, 2 * c),
                rel.reshape(b * nn_, 4, 4),
                cam_intr[:, None].expand(b, nn_, 3, 3).reshape(b * nn_, 3, 3),
                depth_values[:, None].expand(b, nn_, d).reshape(b * nn_, d),
                depth_min, depth_interval, mode=self.frustum_mode,
            ).reshape(b, nn_, d, h, w, 2 * c).transpose(0, 1)
            valid_i = torch.stack([all_valid[:, j] for j in nb_idx], 0)
            values[i] = est(key[:, i], values[i], warped[..., :c],
                            warped[..., c:], valid_i)
        return torch.stack(values, 1)

    def forward(self, cost_volumes, semantic_features, target_poses,
                cam_intr, depth_values, depth_min: float,
                depth_interval: float, memory: ESTMemory | None = None,
                use_est: bool = True):
        """cost_volumes [B, num, 32, D, H, W]; semantic_features 5 maps
        [B*num, c, h, w]; target_poses [B, num, 4, 4]; cam_intr [B, 3, 3]
        at 1/4 res; depth_values [B, D].

        Returns (outputs, new_key, new_value, new_pose): outputs "depth"
        [B, num, 4, 4H, 4W] (scale s at index s), "init_prob" and
        "fused_prob" [B, num, 4H, 4W]; the streaming state is the last
        target's key (pre-fusion) and value (fused when EST ran), both
        [B, D, H, W, C], and its pose."""
        b, num, _, d, h, w = cost_volumes.shape
        bn = b * num
        use_est = use_est and self.epipolar_transformer is not None

        semantic_vs = self._semantic_unet(semantic_features)  # [BN,nd,H,W]
        mx = self.dres1(self.dres0(cost_volumes.reshape(bn, -1, d, h, w)))
        # semantic channels reinterpreted as the depth axis (decoder :195)
        x3 = self.dres2(torch.cat([semantic_vs[:, None].to(mx.dtype), mx], 1))
        value = self.value_layer(x3)  # [BN, 16, D, H, W] tanh
        key = self.key_layer(x3)      # relu

        dv_bn = depth_values.repeat_interleave(num, 0)  # [BN, D]
        init_logits = _head_logits(self.stereo_head0, value)
        depth3, prob3 = softargmin_depth(init_logits, dv_bn)

        key_w = key.permute(0, 2, 3, 4, 1).reshape(b, num, d, h, w, -1)
        value_w = value.permute(0, 2, 3, 4, 1).reshape(b, num, d, h, w, -1)
        if use_est:
            fusion = (self._est_fusion_sequential if self.sequential_fusion
                      else self._est_fusion)
            fused = fusion(
                key_w, value_w, target_poses, cam_intr, depth_values,
                depth_min, depth_interval, memory)  # [B, num, D, H, W, C]
            if self.sequential_head_bn and self.training:
                # the reference's loop order: one head call per target, each
                # with its own BN batch statistics and running-stat update
                # (hybrid_depth_decoder.py:229,256)
                fused_logits = torch.stack(
                    [_head_logits(self.stereo_head1,
                                  fused[:, i].permute(0, 4, 1, 2, 3))
                     for i in range(num)], 1).reshape(bn, d, h, w)
            else:
                fused_logits = _head_logits(
                    self.stereo_head1,
                    fused.reshape(bn, d, h, w, -1).permute(0, 4, 1, 2, 3))
            state_value = fused[:, -1]
        else:
            fused_logits = _head_logits(self.stereo_head1, value)
            state_value = value_w[:, -1]
        depth2, prob2 = softargmin_depth(fused_logits, dv_bn)

        # 2D refinement (decoder :264-290): the logits' plane axis becomes
        # channels
        x = self.upconv_1_0(torch.cat(
            [semantic_vs, F.relu(fused_logits.to(semantic_vs.dtype))], 1))
        x = self.upconv_1_1(torch.cat([upsample_nearest(x),
                                       semantic_features[0]], 1))
        depth1 = self.depth_max * torch.sigmoid(self.dispconv_1(x).float())
        x = upsample_nearest(self.upconv_0_0(x))
        x = self.upconv_0_1(x)
        depth0 = self.depth_max * torch.sigmoid(self.dispconv_0(x).float())

        def full(m, factor):  # [BN, (1,) h', w'] -> [B, num, 4H, 4W]
            if m.dim() == 3:
                m = m[:, None]
            if factor > 1:
                m = upsample_nearest(m, factor)
            return m.reshape(b, num, 4 * h, 4 * w)

        outputs = {
            "depth": torch.stack([full(depth0, 1), full(depth1, 2),
                                  full(depth2, 4), full(depth3, 4)], 2),
            "init_prob": full(prob3, 4),
            "fused_prob": full(prob2, 4),
        }
        return (outputs, key_w[:, -1].detach(), state_value.detach(),
                target_poses[:, -1])
