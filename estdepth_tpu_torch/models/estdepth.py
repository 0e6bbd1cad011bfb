"""DepthNetHybrid: the hybrid MVS depth network (port of
estdepth_tpu/models/estdepth.py; reference model_hybrid.py:14-184).

Given V >= 3 frames with poses and intrinsics it predicts full-resolution
depth of the V-2 middle ("target") frames at 4 scales, optionally fusing an
ESTMemory of past key/value volumes (ESTM streaming). All (target,
neighbour) plane-sweep warps run as one folded warp and one folded conv
stack. The matching encoder is `cfg.feature_net`'s: PSMFeatureNet ("psm") or
SEFeatureNet ("senet", whose 1/4-scale map is used). The module tree
carries the reference's names (`matchingFeature`,
`semanticFeature.encoder`, `CostRegNet`, `pre0/1/2`), so its state_dict is
a reference checkpoint and the other way round.

`cfg.compute_dtype` is the dtype the network computes in, as the torch
dtype `compute_dtype`: the frames are cast to it after their
normalization and given matching features on entry, and every layer
computes in the dtype it is given (models/layers.py). The parameters,
BatchNorm's statistics, the softmaxes and the depth outputs stay float32,
and the returned key/value state is in the compute dtype.

Inside `parallel.spatial.width_sharded` the frames, matching features and
memory volumes are one rank's width shard and so are the outputs
(parallel/spatial.make_spatial_window_fn): eval only, with either
matching encoder and either plane sweep.

The module rests in eval mode (BatchNorm on its running statistics).
`forward(..., train=True)` switches it to train mode for that call, as the
JAX module's `train` argument does: BatchNorm normalizes with the batch's
statistics and updates the running ones, and EST fusion runs by default.

Spans (utils/trace.py): `cost_volume` (`_cost_volumes`: the projections,
the plane sweep, the concat and `pre0`-`pre2`). Counters:
`matching.frames` (frames through the matching encoder),
`matching.plan_searches` (matching encoder calls with an encoder, input
shape, dtype, device and train mode new to the process: the calls in
which cuDNN times its plans, `measured_conv_plans`; on the CPU it counts
the keys all the same) and `model.targets` (target depth maps a forward
computes).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from estdepth_tpu_torch.config import ModelConfig, torch_dtype
from estdepth_tpu_torch.models.decoder import DepthHybridDecoder
from estdepth_tpu_torch.models.layers import conv_bn, init_weights
from estdepth_tpu_torch.models.memory import ESTMemory
from estdepth_tpu_torch.models.psm import PSMFeatureNet
from estdepth_tpu_torch.models.resnet import ResNetEncoder
from estdepth_tpu_torch.models.senet import SEFeatureNet
from estdepth_tpu_torch.ops.geometry import (
    camera_projection, scale_intrinsics,
)
from estdepth_tpu_torch.ops.warp import plane_sweep_warp
from estdepth_tpu_torch.ops import shard_context
from estdepth_tpu_torch.utils import trace


@contextlib.contextmanager
def measured_conv_plans():
    """Inside the block cuDNN times its candidate plans for a convolution
    it has not run before and keeps the fastest
    (`torch.backends.cudnn.benchmark`); the caller's setting after. No
    other cuDNN or matmul flag changes (`torch.backends.cudnn.flags()`
    would also set `enabled` and `allow_tf32` to its own defaults)."""
    was = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = was


def _normalize_images(imgs: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """0..255 frames (uint8 or float) -> [-1, 1] (model_hybrid.py:119) in
    float32, then cast to the compute dtype (models/estdepth.py:242-246 of
    the JAX package). The uint8 -> float cast runs on the tensor's device
    and is exact."""
    if not imgs.is_floating_point():
        imgs = imgs.float()
    return (2.0 * (imgs / 255.0) - 1.0).to(dtype)


class DepthNetHybrid(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig(), seed: int = 0):
        """Random weights from `seed` by the JAX package's init scheme
        (models/layers.init_weights); load a state_dict for real ones."""
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        if cfg.feature_net == "psm":
            self.matchingFeature = PSMFeatureNet()
        elif cfg.feature_net == "senet":
            self.matchingFeature = SEFeatureNet()
        else:
            raise ValueError(f"feature_net must be 'psm' or 'senet', got "
                             f"{cfg.feature_net!r}")
        self.semanticFeature = ResNetEncoder(cfg.resnet)
        self.CostRegNet = DepthHybridDecoder(
            self.semanticFeature.num_ch_enc, ndepths=cfg.ndepths,
            depth_max=cfg.depth_max, est_transformer=cfg.est_transformer,
            frustum_mode=cfg.frustum_mode,
            sequential_fusion=cfg.sequential_fusion,
            use_fused_attention=cfg.use_fused_attention,
            sequential_head_bn=cfg.sequential_cost_bn,
        )
        # cost-volume pair aggregation (model_hybrid.py:58-60)
        self.pre0 = conv_bn(64, 32, 1, 1, pad=0, dims=3)
        self.pre1 = conv_bn(32, 32, 3, 1, dims=3, act="relu")
        self.pre2 = conv_bn(32, 32, 3, 1, dims=3, zero_bn_scale=True)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.eval()

    @contextlib.contextmanager
    def _mode(self, train: bool):
        """Train or eval mode inside the block, the caller's mode after."""
        was = self.training
        if was == train:  # nothing to walk the module tree for
            yield
            return
        self.train(train)
        try:
            yield
        finally:
            self.train(was)

    def trains_every_parameter(self, views: int) -> bool:
        """Whether the loss of a train-mode forward over `views` frames
        (no memory) reaches every parameter: the key layer feeds only the
        EST fusion, which needs a window of two targets or more."""
        return self.cfg.est_transformer and views - 2 > 1

    def depth_candidates(self, batch: int, device=None) -> torch.Tensor:
        """[B, D] uniform depth hypotheses (model_hybrid.py:29-33)."""
        c = self.cfg
        cands = (torch.arange(c.ndepths, dtype=torch.float32, device=device)
                 * c.depth_interval + c.depth_min)
        return cands[None].expand(batch, -1)

    def _matching(self, imgs: torch.Tensor) -> torch.Tensor:
        trace.count("matching.frames", imgs.shape[0])
        x = _normalize_images(imgs, self.compute_dtype).permute(0, 3, 1, 2)
        # cuDNN keeps the plan that a convolution's first call chose, so
        # only a call with a new key searches
        trace.count_new("matching.plan_searches", (
            type(self.matchingFeature).__name__, tuple(x.shape), x.dtype,
            x.device, self.training))
        # on an H100 in float32 cuDNN's heuristic gives the 5-frame batch's
        # 320-channel `lastconv` FFT tiles, 150x the time of the implicit
        # GEMM that a measured choice takes; the search runs once a shape
        with measured_conv_plans():
            feats = self.matchingFeature(x)
        if isinstance(feats, tuple):  # SEFeatureNet: (1/2, 1/4) maps
            feats = feats[-1]
        return feats.permute(0, 2, 3, 1)

    def compute_matching(self, imgs: torch.Tensor) -> torch.Tensor:
        """Stride-4 matching features [N, H/4, W/4, 32] (channels-last) of
        [N, H, W, 3] frames in 0..255, always in eval mode: eval-mode BN
        makes them per-frame deterministic, so streaming runners cache
        them across windows."""
        with self._mode(False):
            return self._matching(imgs)

    @trace.spanned("cost_volume")
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
            dv.reshape(bp, d), two_pass=self.cfg.two_pass_warp,
        )  # [BP, D, h, w, C]
        # ref volume expanded over planes (model_hybrid.py:76)
        ref = feats[:, 1:1 + t].permute(0, 1, 4, 2, 3)  # [B, T, C, h, w]
        ref = ref[None, :, :, :, None].expand(2, b, t, c, d, h, w)
        x = torch.cat([ref.reshape(bp, c, d, h, w),
                       warped.permute(0, 4, 1, 2, 3)], 1)  # 64 channels
        if self.cfg.sequential_cost_bn and self.training:
            # the reference's loop order (t0, L), (t0, R), (t1, L), ...: one
            # pre-stack call per pair, each with its own BN batch statistics
            # and its own update of the running ones
            ys = []
            for ti in range(t):
                for pi in range(2):
                    rows = pi * b * t + torch.arange(b, device=x.device) * t
                    yi = self.pre0(x[rows + ti])
                    ys.append(yi + self.pre2(self.pre1(yi)))
            y = torch.stack(ys, 0).reshape(t, 2, b, -1, d, h, w)
            return y.mean(1).transpose(0, 1)  # [B, T, 32, D, h, w]
        x = self.pre0(x)
        x = x + self.pre2(self.pre1(x))
        # mean over the 2 neighbours (model_hybrid.py:97-99)
        return x.reshape(2, b, t, -1, d, h, w).mean(0)

    def _after_features(self, train, use_est, memory, cam_poses, cam_intr,
                        matching_feats, *semantic):
        """Everything after the two encoders: cost volumes and decoder."""
        with self._mode(train):
            b, v = cam_poses.shape[:2]
            t = v - 2
            cam_intr_s1 = scale_intrinsics(cam_intr, 0.25)
            depth_values = self.depth_candidates(b, cam_poses.device)
            cost_volumes = self._cost_volumes(matching_feats, cam_poses,
                                              cam_intr_s1, depth_values)
            outputs, key, value, pose = self.CostRegNet(
                cost_volumes, list(semantic), cam_poses[:, 1:1 + t],
                cam_intr_s1, depth_values, self.cfg.depth_min,
                self.cfg.depth_interval, memory=memory, use_est=use_est,
            )
        return outputs, (key, value, pose)

    def forward(self, imgs: torch.Tensor, cam_poses: torch.Tensor,
                cam_intr: torch.Tensor, memory: ESTMemory | None = None,
                use_est: bool | None = None, train: bool = False,
                matching_feats: torch.Tensor | None = None,
                remat_after_features: bool = False):
        """imgs [B, V, H, W, 3] in 0..255; cam_poses [B, V, 4, 4]
        cam-to-world; cam_intr [B, 3, 3] at full resolution.

        Returns (outputs, (key, value, pose)): outputs "depth"
        [B, T, 4, H, W], "init_prob" and "fused_prob" [B, T, H, W]; the
        state is the last target's for ESTMemory.push, detached. `use_est`
        defaults to the reference's flag logic
        (hybrid_depth_decoder.py:423): EST fusion runs when training or
        when a memory is given. `train` runs the call in train mode
        (module doc). `matching_feats` [B, V, H/4, W/4, C] from
        compute_matching skips the matching encoder.
        `remat_after_features` keeps only the encoders' outputs for the
        backward and recomputes the cost volumes and the decoder there
        (torch.utils.checkpoint; the JAX trainer's "save_features")."""
        b, v, h_img, w_img, _ = imgs.shape
        if v <= 2:
            raise ValueError("need at least 3 views (model_hybrid.py:123)")
        t = v - 2
        trace.count("model.targets", b * t)
        if use_est is None:
            use_est = self.cfg.est_transformer and (train
                                                    or memory is not None)
        if shard_context.current() is not None and train:
            raise ValueError("a width-sharded forward is eval only "
                             "(train=False), as the JAX function")
        if train and use_est and self.cfg.use_fused_attention:
            raise ValueError(
                "use_fused_attention cannot train: the attention kernel is "
                "forward-only (no gradient, as the TPU kernel); train with "
                "use_fused_attention=False")
        with self._mode(train):
            x = _normalize_images(imgs, self.compute_dtype)
            if matching_feats is None:
                matching_feats = self._matching(
                    imgs.reshape(b * v, h_img, w_img, 3)
                ).reshape(b, v, h_img // 4, w_img // 4, -1)
            else:
                matching_feats = matching_feats.to(self.compute_dtype)
            semantic = self.semanticFeature(
                x[:, 1:1 + t].reshape(b * t, h_img, w_img, 3)
                .permute(0, 3, 1, 2))
        rest = (train, use_est, memory, cam_poses, cam_intr, matching_feats,
                *semantic)
        if remat_after_features:
            return checkpoint(self._after_features, *rest,
                              use_reentrant=False)
        return self._after_features(*rest)
