"""Offline numpy metric suite for dumped depth maps (the port's own copy of
estdepth_tpu/eval/metric_offline.py).

Behavioral equivalent of the reference's metric.py:4-353: the scorer
applied to .npy depth dumps after evaluation. Pure numpy, host-side.

All distances operate on pre-masked 1-D arrays of positive, finite depths;
`compute_errors` applies the valid mask (both maps within
(min_thred, max_thred), default 0.3-5.0 m, metric.py:4-17).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

DEFAULT_DISTANCES = (
    "l1",
    "l1_inverse",
    "scale_invariant",
    "abs_relative",
    "sq_relative",
    "avg_log10",
    "rmse_log",
    "rmse",
    "ratio_threshold_1.25",
    "ratio_threshold_1.5625",
    "ratio_threshold_1.953125",
)


def valid_depth_mask(
    d1: np.ndarray,
    d2: Optional[np.ndarray] = None,
    min_thred: float = 0.3,
    max_thred: float = 5.0,
) -> np.ndarray:
    """Valid iff finite and inside (min_thred, max_thred) in both maps."""
    if d2 is None:
        return (d1 < max_thred) & (d1 > min_thred) & np.isfinite(d1)
    return (
        (d1 < max_thred)
        & (d2 < max_thred)
        & (d1 > min_thred)
        & (d2 > min_thred)
        & np.isfinite(d1)
        & np.isfinite(d2)
    )


def _require_positive(pred: np.ndarray, gt: np.ndarray) -> None:
    if not np.all(np.isfinite(pred) & np.isfinite(gt) & (pred > 0)
                  & (gt > 0)):
        raise ValueError("metric inputs must be finite and positive; mask "
                         "them first (compute_errors does)")


def _guard(pred: np.ndarray, gt: np.ndarray) -> bool:
    """True when there is nothing to score."""
    _require_positive(pred, gt)
    return pred.size == 0


def l1(pred, gt):
    if _guard(pred, gt):
        return np.nan
    return float(np.mean(np.abs(pred - gt)))


def l1_inverse(pred, gt):
    if _guard(pred, gt):
        return np.nan
    return float(np.mean(np.abs(1.0 / pred - 1.0 / gt)))


def rmse(pred, gt):
    if _guard(pred, gt):
        return np.nan
    return float(np.sqrt(np.mean(np.square(pred - gt))))


def rmse_log(pred, gt):
    if _guard(pred, gt):
        return np.nan
    return float(np.sqrt(np.mean(np.square(np.log(pred) - np.log(gt)))))


def scale_invariant(pred, gt):
    """sqrt of Eigen et al.'s scale-invariant MSE (metric.py:108-128)."""
    if _guard(pred, gt):
        return np.nan
    log_diff = np.log(pred) - np.log(gt)
    # clamp: fp rounding can push the variance epsilon-negative for
    # constant-ratio predictions
    var = np.mean(np.square(log_diff)) - np.square(np.mean(log_diff))
    return float(np.sqrt(max(var, 0.0)))


def abs_relative(pred, gt):
    if _guard(pred, gt):
        return np.nan
    return float(np.mean(np.abs(pred - gt) / gt))


def sq_relative(pred, gt):
    if _guard(pred, gt):
        return np.nan
    return float(np.mean(np.square(pred - gt) / gt))


def avg_log10(pred, gt):
    if _guard(pred, gt):
        return np.nan
    return float(np.mean(np.abs(np.log10(pred) - np.log10(gt))))


def ratio_threshold(pred, gt, threshold: float):
    if not threshold > 0.0:
        raise ValueError(f"ratio threshold {threshold} must be positive")
    if _guard(pred, gt):
        return np.nan
    log_diff = np.log(pred) - np.log(gt)
    return float(np.mean(np.abs(log_diff) < np.log(threshold)))


def compute_errors(
    depth_pred: np.ndarray,
    depth_gt: np.ndarray,
    distances_to_compute: Optional[Sequence[str]] = None,
    min_thred: float = 0.3,
    max_thred: float = 5.0,
) -> Dict[str, float]:
    """Mask both maps to the shared valid range, then score (metric.py:220-259)."""
    mask = valid_depth_mask(depth_gt, depth_pred, min_thred, max_thred)
    pred = depth_pred[mask]
    gt = depth_gt[mask]
    if distances_to_compute is None:
        distances_to_compute = DEFAULT_DISTANCES

    fns = {
        "l1": l1,
        "l1_inverse": l1_inverse,
        "scale_invariant": scale_invariant,
        "abs_relative": abs_relative,
        "sq_relative": sq_relative,
        "avg_log10": avg_log10,
        "rmse_log": rmse_log,
        "rmse": rmse,
    }
    results: Dict[str, float] = {"num_valid": int(mask.sum())}
    for dist in distances_to_compute:
        if dist.startswith("ratio_threshold"):
            results[dist] = ratio_threshold(pred, gt, float(dist.split("_")[-1]))
        else:
            results[dist] = fns[dist](pred, gt)
    return results


def depth_scale_factor(pred, gt, depth_scaling: str = "abs") -> float:
    """Least-squares scale aligning pred to gt (metric.py:262-300).

    Reference quirk preserved: for 'abs' and 'inv' the sums run only over
    elements whose PRODUCT pred*gt (resp. (1/pred)*(1/gt)) falls inside the
    (0.3, 5.0) depth-range mask (metric.py:271-272,288-289) — the range test
    is applied to the product, not the depths."""
    _require_positive(pred, gt)
    if depth_scaling == "abs":
        d11 = pred * pred
        d12 = pred * gt
        m = valid_depth_mask(d12)
        s11 = float(np.sum(d11[m]))
        s12 = float(np.sum(d12[m]))
        return s12 / s11 if s11 > 0 else 1.0
    if depth_scaling == "log":
        return float(np.exp(np.mean(np.log(gt) - np.log(pred))))
    if depth_scaling == "inv":
        ip, ig = 1.0 / pred, 1.0 / gt
        d11 = ip * ip
        d12 = ip * ig
        m = valid_depth_mask(d12)
        s11 = float(np.sum(d11[m]))
        s12 = float(np.sum(d12[m]))
        return 1.0 / (s12 / s11) if s11 > 0 else 1.0
    raise ValueError(f"unknown depth scaling: {depth_scaling}")


def evaluate_depth(
    translation_gt: np.ndarray,
    depth_gt_in: np.ndarray,
    depth_pred_in: np.ndarray,
    distances_to_compute: Optional[Sequence[str]] = None,
    inverse_gt: bool = True,
    inverse_pred: bool = True,
    depth_scaling: str = "abs",
    depth_pred_max: float = np.inf,
):
    """(errors, errors_after_optimal_scaling) — full port of
    metric.py:303-353, including its quirks:

      * pre-mask on (pred, gt) in the metric range, THEN optional inversion
        to inverse depth (`inverse_gt`/`inverse_pred`, default True);
      * GT rescaling by the ground-truth translation norm when it is not
        already normalized (DeMoN-style scale-ambiguous evaluation);
      * `depth_pred_max` is accepted but has no effect — the clamp is
        commented out in the reference (metric.py:335-336);
      * `compute_errors` re-masks its (possibly inverted/rescaled) inputs in
      the same absolute 0.3-5.0 range (metric.py:238).
    """
    del depth_pred_max  # reference behavior: clamp is commented out
    valid_mask = valid_depth_mask(depth_pred_in, depth_gt_in)
    depth_pred = depth_pred_in[valid_mask]
    depth_gt = depth_gt_in[valid_mask]
    if inverse_gt:
        depth_gt = np.reciprocal(depth_gt)
    if inverse_pred:
        depth_pred = np.reciprocal(depth_pred)

    translation_gt = np.asarray(translation_gt, dtype=np.float64)
    translation_norm = float(np.sqrt(translation_gt.dot(translation_gt)))
    if not np.isclose(1.0, translation_norm):
        depth_gt = depth_gt / translation_norm

    errs = compute_errors(depth_pred, depth_gt, distances_to_compute)
    scale = depth_scale_factor(depth_pred, depth_gt, depth_scaling)
    errs_scaled = compute_errors(
        depth_pred * scale, depth_gt, distances_to_compute
    )
    return errs, errs_scaled


def evaluate_depth_metric(
    depth_gt: np.ndarray,
    depth_pred: np.ndarray,
    distances_to_compute: Optional[Sequence[str]] = None,
    depth_scaling: str = "abs",
):
    """(errors, errors_after_optimal_scaling) on metric (non-inverse) depths
    with no translation rescaling — the common case for ScanNet/7-Scenes
    where poses are metric (equivalent to evaluate_depth with unit
    translation and inverse_* False)."""
    mask = valid_depth_mask(depth_pred, depth_gt)
    pred = depth_pred[mask]
    gt = depth_gt[mask]
    errs = compute_errors(pred, gt, distances_to_compute)
    scale = depth_scale_factor(pred, gt, depth_scaling)
    errs_scaled = compute_errors(pred * scale, gt, distances_to_compute)
    return errs, errs_scaled
