"""DepthNetHybrid: the hybrid MVS depth network, eval mode (port of
estdepth_tpu/models/estdepth.py; reference model_hybrid.py:14-184).

Given V >= 3 frames with poses and intrinsics it predicts full-resolution
depth of the V-2 middle ("target") frames at 4 scales, optionally fusing an
ESTMemory of past key/value volumes (ESTM streaming). All (target,
neighbour) plane-sweep warps run as one folded warp and one folded conv
stack. The module tree carries the reference's names (`matchingFeature`,
`semanticFeature.encoder`, `CostRegNet`, `pre0/1/2`), so its state_dict is
a reference checkpoint and the other way round.
"""

from __future__ import annotations

import torch
from torch import nn

from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.models.decoder import DepthHybridDecoder
from estdepth_tpu_torch.models.layers import conv_bn, init_weights
from estdepth_tpu_torch.models.memory import ESTMemory
from estdepth_tpu_torch.models.psm import PSMFeatureNet
from estdepth_tpu_torch.models.resnet import ResNetEncoder
from estdepth_tpu_torch.ops.geometry import (
    camera_projection, scale_intrinsics,
)
from estdepth_tpu_torch.ops.warp import plane_sweep_warp


def _normalize_images(imgs: torch.Tensor) -> torch.Tensor:
    """0..255 frames (uint8 or float) -> [-1, 1] (model_hybrid.py:119).
    The uint8 -> float cast runs on the tensor's device and is exact."""
    if not imgs.is_floating_point():
        imgs = imgs.float()
    return 2.0 * (imgs / 255.0) - 1.0


class DepthNetHybrid(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig(), seed: int = 0):
        """Random weights from `seed` by the JAX package's init scheme
        (models/layers.init_weights); load a state_dict for real ones."""
        super().__init__()
        self.cfg = cfg
        self.matchingFeature = PSMFeatureNet()
        self.semanticFeature = ResNetEncoder(cfg.resnet)
        self.CostRegNet = DepthHybridDecoder(
            self.semanticFeature.num_ch_enc, ndepths=cfg.ndepths,
            depth_max=cfg.depth_max, est_transformer=cfg.est_transformer,
            frustum_mode=cfg.frustum_mode,
            sequential_fusion=cfg.sequential_fusion,
            use_fused_attention=cfg.use_fused_attention,
        )
        # cost-volume pair aggregation (model_hybrid.py:58-60)
        self.pre0 = conv_bn(64, 32, 1, 1, pad=0, dims=3)
        self.pre1 = conv_bn(32, 32, 3, 1, dims=3, act="relu")
        self.pre2 = conv_bn(32, 32, 3, 1, dims=3, zero_bn_scale=True)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.eval()

    def depth_candidates(self, batch: int, device=None) -> torch.Tensor:
        """[B, D] uniform depth hypotheses (model_hybrid.py:29-33)."""
        c = self.cfg
        cands = (torch.arange(c.ndepths, dtype=torch.float32, device=device)
                 * c.depth_interval + c.depth_min)
        return cands[None].expand(batch, -1)

    def compute_matching(self, imgs: torch.Tensor) -> torch.Tensor:
        """Stride-4 matching features [N, H/4, W/4, 32] (channels-last) of
        [N, H, W, 3] frames in 0..255. Eval-mode BN makes them per-frame
        deterministic, so streaming runners cache them across windows."""
        x = _normalize_images(imgs).permute(0, 3, 1, 2)
        return self.matchingFeature(x).permute(0, 2, 3, 1)

    def _cost_volumes(self, feats, cam_poses, cam_intr_s1, depth_values):
        """All targets' cost volumes (model_hybrid.py:62-102,152-164):
        feats [B, V, h, w, 32] channels-last -> [B, T, 32, D, h, w].

        Each target t in 1..V-2 is swept against neighbours t-1 and t+1,
        [ref, warped] runs pre0 + residual(pre2 . pre1), and the two
        neighbour contributions are averaged."""
        b, v, h, w, c = feats.shape
        t = v - 2
        d = depth_values.shape[1]
        proj = camera_projection(
            cam_intr_s1[:, None].expand(b, v, 3, 3).reshape(b * v, 3, 3),
            cam_poses.reshape(b * v, 4, 4),
        ).reshape(b, v, 4, 4)
        bp = 2 * b * t
        # neighbour pairs: left = t-1, right = t+1; the pair axis leads
        src_feats = torch.stack([feats[:, 0:t], feats[:, 2:2 + t]], 0)
        src_proj = torch.stack([proj[:, 0:t], proj[:, 2:2 + t]], 0)
        ref_proj = proj[:, 1:1 + t][None].expand(2, b, t, 4, 4)
        dv = depth_values[None, :, None].expand(2, b, t, d)
        warped = plane_sweep_warp(
            src_feats.reshape(bp, h, w, c).contiguous(),
            src_proj.reshape(bp, 4, 4), ref_proj.reshape(bp, 4, 4),
            dv.reshape(bp, d),
        )  # [BP, D, h, w, C]
        # ref volume expanded over planes (model_hybrid.py:76)
        ref = feats[:, 1:1 + t].permute(0, 1, 4, 2, 3)  # [B, T, C, h, w]
        ref = ref[None, :, :, :, None].expand(2, b, t, c, d, h, w)
        x = torch.cat([ref.reshape(bp, c, d, h, w),
                       warped.permute(0, 4, 1, 2, 3)], 1)  # 64 channels
        x = self.pre0(x)
        x = x + self.pre2(self.pre1(x))
        # mean over the 2 neighbours (model_hybrid.py:97-99)
        return x.reshape(2, b, t, -1, d, h, w).mean(0)

    def forward(self, imgs: torch.Tensor, cam_poses: torch.Tensor,
                cam_intr: torch.Tensor, memory: ESTMemory | None = None,
                use_est: bool | None = None,
                matching_feats: torch.Tensor | None = None):
        """imgs [B, V, H, W, 3] in 0..255; cam_poses [B, V, 4, 4]
        cam-to-world; cam_intr [B, 3, 3] at full resolution.

        Returns (outputs, (key, value, pose)): outputs "depth"
        [B, T, 4, H, W], "init_prob" and "fused_prob" [B, T, H, W]; the
        state is the last target's for ESTMemory.push. `use_est` defaults
        to "a memory was given" (the reference's eval flag,
        hybrid_depth_decoder.py:423). `matching_feats` [B, V, H/4, W/4, C]
        from compute_matching skips the matching encoder."""
        b, v, h_img, w_img, _ = imgs.shape
        if v <= 2:
            raise ValueError("need at least 3 views (model_hybrid.py:123)")
        t = v - 2
        if use_est is None:
            use_est = self.cfg.est_transformer and memory is not None
        x = _normalize_images(imgs)
        if matching_feats is None:
            matching_feats = self.compute_matching(
                imgs.reshape(b * v, h_img, w_img, 3)
            ).reshape(b, v, h_img // 4, w_img // 4, -1)
        semantic = self.semanticFeature(
            x[:, 1:1 + t].reshape(b * t, h_img, w_img, 3).permute(0, 3, 1, 2))
        cam_intr_s1 = scale_intrinsics(cam_intr, 0.25)
        depth_values = self.depth_candidates(b, imgs.device)
        cost_volumes = self._cost_volumes(matching_feats, cam_poses,
                                          cam_intr_s1, depth_values)
        outputs, key, value, pose = self.CostRegNet(
            cost_volumes, semantic, cam_poses[:, 1:1 + t], cam_intr_s1,
            depth_values, self.cfg.depth_min, self.cfg.depth_interval,
            memory=memory, use_est=use_est,
        )
        return outputs, (key, value, pose)
