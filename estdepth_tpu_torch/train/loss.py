"""Multi-scale masked L1 depth loss and training stats (port of
estdepth_tpu/train/loss.py; reference model_hybrid.py:186-252).

Where-masked reductions, as in the JAX package:
  * per (scale, target): the mean of |pred - gt| over the valid pixels,
    pooled across the whole batch (F.l1_loss(pred[mask], gt[mask]), :209);
  * per-scale losses averaged over targets (:218) and combined with weight
    0.8**scale (:219);
  * delta (< 1.25) and abs_rel on gt in (depth_min, depth_max) with the
    prediction clamped into that range (:239-252).
"""

from __future__ import annotations

from typing import Sequence

import torch


def _masked_mean_per_target(x: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the valid pixels, pooled over (B, H, W) per target:
    x, mask [B, T, H, W] -> [T]."""
    m = mask.float()
    num = (x.float() * m).sum((0, 2, 3))
    den = m.sum((0, 2, 3)).clamp(min=1.0)
    return num / den


def depth_stats(gt: torch.Tensor, pred: torch.Tensor, depth_min: float,
                depth_max: float):
    """delta < 1.25 and abs_rel per target (model_hybrid.py:239-252):
    gt, pred [B, T, H, W] -> ([T], [T])."""
    mask = (gt > depth_min) & (gt < depth_max)
    pr = pred.clamp(depth_min, depth_max)
    safe_gt = torch.where(mask, gt, torch.ones_like(gt))
    thresh = torch.maximum(safe_gt / pr, pr / safe_gt)
    delta = _masked_mean_per_target((thresh < 1.25).float(), mask)
    abs_rel = _masked_mean_per_target((safe_gt - pr).abs() / safe_gt, mask)
    return delta, abs_rel


def edge_aware_smoothness(disp: torch.Tensor,
                          img: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness (model_hybrid.py:224-237), present but
    disabled in the reference recipe (:206-208). disp [B, H, W], img
    [B, H, W, 3] in [-1, 1]."""
    dx = (disp[:, :, :-1] - disp[:, :, 1:]).abs()
    dy = (disp[:, :-1, :] - disp[:, 1:, :]).abs()
    gx = (img[:, :, :-1] - img[:, :, 1:]).abs().mean(-1)
    gy = (img[:, :-1, :] - img[:, 1:, :]).abs().mean(-1)
    return (dx * torch.exp(-gx)).mean() + (dy * torch.exp(-gy)).mean()


def multi_scale_loss(pred_depths: torch.Tensor, gt_depth: torch.Tensor,
                     gt_mask: torch.Tensor, depth_min: float,
                     depth_max: float, scales: Sequence[int] = (0, 1, 2, 3),
                     weight: float = 0.8):
    """pred_depths [B, T, S, H, W] (scale s at index s), gt_depth and
    gt_mask [B, T, H, W] -> (total loss, scalars): `loss`, and per scale
    `loss_s`, `delta_s`, `thred_s` (detached)."""
    scalars: dict[str, torch.Tensor] = {}
    total = pred_depths.new_zeros((), dtype=torch.float32)
    for s in scales:
        pred = pred_depths[:, :, s]
        per_t = _masked_mean_per_target((pred - gt_depth).abs(), gt_mask)
        loss_s = per_t.mean()
        with torch.no_grad():
            delta, abs_rel = depth_stats(gt_depth, pred, depth_min, depth_max)
        scalars[f"loss_{s}"] = loss_s.detach()
        scalars[f"delta_{s}"] = delta.mean()
        scalars[f"thred_{s}"] = abs_rel.mean()
        total = total + (weight ** s) * loss_s
    scalars["loss"] = total.detach()
    return total, scalars
