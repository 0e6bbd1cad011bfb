"""On-device eval metrics (port of estdepth_tpu/eval/metrics.py).

Behavioral equivalent of DepthNetHybrid.depth_metrics / .metrics (the
reference's hybrid_models/model_hybrid.py:254-314): a1/a2/a3
(delta < 1.25^k), abs_diff, abs_rel, sq_rel, rmse, rmse_log per scale,
averaged over targets, with masked reductions. Computed on the tensors'
device; each value is a 0-d float32 tensor there.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over batch and pixels of each target: [B, T, H, W] -> [T]."""
    m = mask.float()
    return (x.float() * m).sum((0, 2, 3)) / m.sum((0, 2, 3)).clamp_min(1.0)


def depth_metrics(
    pred_depths: torch.Tensor,  # [B, T, S, H, W]
    gt_depth: torch.Tensor,     # [B, T, H, W]
    gt_mask: torch.Tensor,      # [B, T, H, W] bool
    scales: Sequence[int] = (0, 2),
) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    one = torch.ones((), dtype=gt_depth.dtype, device=gt_depth.device)
    gt = torch.where(gt_mask, gt_depth, one)
    for s in scales:
        pred = pred_depths[:, :, s]
        pred = torch.where(gt_mask & (pred > 0), pred, one)
        thresh = torch.maximum(gt / pred, pred / gt)
        diff = gt - pred
        out[f"a1_{s}"] = _masked_mean(thresh < 1.25, gt_mask).mean()
        out[f"a2_{s}"] = _masked_mean(thresh < 1.25**2, gt_mask).mean()
        out[f"a3_{s}"] = _masked_mean(thresh < 1.25**3, gt_mask).mean()
        out[f"abs_diff_{s}"] = _masked_mean(diff.abs(), gt_mask).mean()
        out[f"abs_rel_{s}"] = _masked_mean(diff.abs() / gt, gt_mask).mean()
        out[f"sq_rel_{s}"] = _masked_mean(diff**2 / gt, gt_mask).mean()
        # rmse pools over valid pixels per target before the sqrt
        out[f"rmse_{s}"] = _masked_mean(diff**2, gt_mask).sqrt().mean()
        msle = _masked_mean((gt.log() - pred.log()) ** 2, gt_mask)
        out[f"rmse_log_{s}"] = msle.sqrt().mean()
    return out
