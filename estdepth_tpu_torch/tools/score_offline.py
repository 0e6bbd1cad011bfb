"""Offline scorer for dumped depth maps (the reference's metric.py workflow;
counterpart of tools/score_offline.py).

The reference's evaluation protocol is two-stage: the eval scripts dump
per-frame `.npy` depth maps (the reference's eval_hybrid_seq.py:200-258)
and `metric.py` scores them offline against ground truth afterwards
(metric.py:220-353, imported by both eval scripts). The eval tools can
score inline, but the decoupled workflow — score any directory of dumps,
re-score with different masks/alignment without re-running the model — needs
a standalone CLI. This is it.

Prediction layouts understood (as produced by tools/eval_estm.py; the
joint tool's window-indexed dumps are not scoreable here — their indices
name (window, target) pairs, not stream frames):
  * flat:      <preddir>/<scene>_<idx:06d>_depth.npy  (refined scale-0)
               <preddir>/<scene>_<idx:06d>_init.npy   (fused scale-2 head)
  * reference: <preddir>/<scene>/{refined_depth,init_depth}/<idx:06d>.npy
               (eval_hybrid_seq.py:144-156 output tree)

<idx> is the frame's index in the subsampled stream (every
`--frame-interval`-th valid-pose frame), matching what the eval tools wrote.

Without OpenCV only PNG ground truth can be read, and predictions are
resized to it with the port's own INTER_LINEAR (data/io_utils.py).

Usage:
  python -m estdepth_tpu_torch.tools.score_offline --preddir out/ \
      --datapath /data/scannet_test --testlist test_split.txt
  python -m estdepth_tpu_torch.tools.score_offline --preddir out/ \
      --synthetic                                                # hermetic
  python -m estdepth_tpu_torch.tools.score_offline --preddir out/ ... \
      --scale-align log --which init --json scores.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from estdepth_tpu_torch.data.io_utils import read_split_file, resize
from estdepth_tpu_torch.eval.metric_offline import (
    DEFAULT_DISTANCES,
    compute_errors,
    depth_scale_factor,
    evaluate_depth,
    valid_depth_mask,
)
from estdepth_tpu_torch.tools.gt_stream import gt_frames

REPORT_KEYS = (
    "abs_relative",
    "sq_relative",
    "rmse",
    "rmse_log",
    "ratio_threshold_1.25",
    "ratio_threshold_1.5625",
    "ratio_threshold_1.953125",
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--preddir", type=str, required=True)
    p.add_argument("--datapath", type=str, default=None)
    p.add_argument("--testlist", type=str, default=None)
    p.add_argument("--eval-dataset", choices=["scannet", "7scenes"],
                   default="scannet")
    p.add_argument("--synthetic", action="store_true",
                   help="GT from the synthetic scene generator (hermetic)")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--frame-interval", type=int, default=10)
    p.add_argument("--start-index", type=int, default=0,
                   help="MUST match the eval run's --start-index: dump "
                        "indices are positions in the offset subsampled "
                        "stream")
    p.add_argument("--which", choices=["refined", "init"], default="refined",
                   help="which dumped map to score (reference naming: "
                        "'refined' = scale-0, 'init' = fused scale-2 head)")
    p.add_argument("--min-depth", type=float, default=0.3,
                   help="metric valid range lower bound (metric.py:4)")
    p.add_argument("--max-depth", type=float, default=5.0)
    p.add_argument("--scale-align", choices=["none", "abs", "log", "inv"],
                   default="none",
                   help="also report metrics after least-squares scale "
                        "alignment of pred to GT (metric.py:262-300)")
    p.add_argument("--inverse", action="store_true",
                   help="score in inverse-depth space with translation-norm "
                        "GT rescaling (metric.py:303-353 evaluate_depth "
                        "defaults; needs per-frame poses)")
    p.add_argument("--json", type=str, default=None,
                   help="write per-scene + overall means to this JSON file")
    return p.parse_args(argv)


def _pred_path(preddir: str, scene: str, idx: int, which: str) -> Optional[str]:
    flat = os.path.join(
        preddir,
        f"{scene}_{idx:06d}_{'depth' if which == 'refined' else 'init'}.npy",
    )
    if os.path.exists(flat):
        return flat
    ref = os.path.join(preddir, scene, f"{which}_depth", f"{idx:06d}.npy")
    return ref if os.path.exists(ref) else None


def _discover_scenes(preddir: str) -> List[str]:
    """Scene names present in a dump directory (either layout)."""
    scenes = set()
    for f in glob.glob(os.path.join(preddir, "*_depth.npy")):
        m = re.match(r"(.+)_(\d{6})_(depth|init)\.npy$", os.path.basename(f))
        if m:
            scenes.add(m.group(1))
    for d in glob.glob(os.path.join(preddir, "*", "refined_depth")):
        scenes.add(os.path.basename(os.path.dirname(d)))
    return sorted(scenes)


def _gt_frames(args, scene: str) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
    """(stream_index, frame-with-dmap/pose) pairs for one scene."""
    yield from gt_frames(
        scene, synthetic=args.synthetic, datapath=args.datapath,
        eval_dataset=args.eval_dataset, height=args.height,
        width=args.width, frame_interval=args.frame_interval,
        start_index=args.start_index, depth_min=args.min_depth,
        depth_max=args.max_depth,
    )


def _resize_to(pred: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    if pred.shape == shape:
        return pred
    return resize(pred.astype(np.float32), shape[1], shape[0])


def score_scene(args, scene: str) -> List[Dict[str, float]]:
    per_frame = []
    for idx, f in _gt_frames(args, scene):
        path = _pred_path(args.preddir, scene, idx, args.which)
        if path is None:
            continue
        gt = np.asarray(f["dmap"], np.float32)
        if f.get("dmask") is not None:
            gt = np.where(f["dmask"], gt, 0.0)
        pred = _resize_to(np.load(path).astype(np.float32), gt.shape)

        if args.inverse:
            t = np.asarray(f["cam_pose"], np.float64)[:3, 3]
            if not np.dot(t, t) > 0:
                # evaluate_depth rescales GT by ||translation_gt||
                # (metric.py:330-333); a zero-translation frame is
                # unscoreable under that protocol
                continue
            errs, errs_scaled = evaluate_depth(
                t, gt, pred,
                depth_scaling="abs" if args.scale_align == "none"
                else args.scale_align,
            )
            row = dict(errs)
            if args.scale_align != "none":
                row.update({f"scaled_{k}": v for k, v in errs_scaled.items()})
        else:
            row = compute_errors(
                pred, gt, DEFAULT_DISTANCES, args.min_depth, args.max_depth
            )
            if args.scale_align != "none":
                m = valid_depth_mask(pred, gt, args.min_depth, args.max_depth)
                if m.any():
                    s = depth_scale_factor(pred[m], gt[m], args.scale_align)
                    scaled = compute_errors(
                        pred * s, gt, DEFAULT_DISTANCES,
                        args.min_depth, args.max_depth,
                    )
                    row.update(
                        {f"scaled_{k}": v for k, v in scaled.items()}
                    )
                    row["scale"] = s
        if row.get("num_valid", 0) > 0:
            per_frame.append(row)
    return per_frame


def _mean(rows: List[Dict[str, float]]) -> Dict[str, float]:
    keys = sorted({k for r in rows for k in r if k != "num_valid"})
    return {
        k: float(np.nanmean([r[k] for r in rows if k in r])) for k in keys
    }


def main(argv=None) -> dict:
    """Score the dumps; returns the JSON's "overall" and "per_scene"."""
    args = parse_args(argv)
    if not args.synthetic and not args.datapath:
        raise SystemExit("need --datapath (or --synthetic) for ground truth")

    if args.testlist:
        present = set(_discover_scenes(args.preddir))
        scenes = [
            s for s in read_split_file(args.testlist) if s in present
        ] or sorted(present)
    else:
        scenes = _discover_scenes(args.preddir)
    if not scenes:
        raise SystemExit(f"no predictions found under {args.preddir}")

    header = ["scene", "frames"] + [k.replace("ratio_threshold", "d<")
                                    for k in REPORT_KEYS]
    print("  ".join(f"{h:>16s}" for h in header))
    all_rows, per_scene = [], {}
    for scene in scenes:
        rows = score_scene(args, scene)
        if not rows:
            print(f"{scene:>16s}  {'0':>16s}  (no scored frames)")
            continue
        means = _mean(rows)
        per_scene[scene] = dict(means, frames=len(rows))
        all_rows += rows
        cells = [f"{scene:>16s}", f"{len(rows):>16d}"] + [
            f"{means.get(k, float('nan')):>16.4f}" for k in REPORT_KEYS
        ]
        print("  ".join(cells))

    if not all_rows:
        raise SystemExit("no frames scored")
    overall = _mean(all_rows)
    cells = [f"{'OVERALL':>16s}", f"{len(all_rows):>16d}"] + [
        f"{overall.get(k, float('nan')):>16.4f}" for k in REPORT_KEYS
    ]
    print("  ".join(cells))

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(
                {"overall": dict(overall, frames=len(all_rows)),
                 "per_scene": per_scene, "args": vars(args)},
                fh, indent=2,
            )
        print(f"wrote {args.json}")
    return {"overall": dict(overall, frames=len(all_rows)),
            "per_scene": per_scene}


if __name__ == "__main__":
    main()
