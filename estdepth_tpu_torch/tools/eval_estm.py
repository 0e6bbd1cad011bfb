"""ESTM streaming evaluation on the port (counterpart of tools/eval_estm.py).

    python -m estdepth_tpu_torch.tools.eval_estm --synthetic

Streams scenes frame by frame through ESTMRunner (lwindow 3, memory 2 by
default) and reports the steady-state time per frame and the offline
metrics of the refined (scale 0) depth against ground truth. The defaults
are the JAX tool's: 256x320 frames, 64 planes in [0.01, 10] m, ResNet-50,
two synthetic scenes of 12 frames. Synthetic ground truth is rendered at
the output resolution, so no resize (and no OpenCV) is needed. Weights are
random from --seed (real weights load with `model.load_state_dict`, e.g.
from utils/convert.state_dict_from_jax). --no-exact-z, --exact-warp and
--fused-attention pick the frustum warp and the attention kernel. Runs on
the CUDA device unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from estdepth_tpu_torch.config import (
    EvalConfig, ModelConfig, add_model_flags, resolve_device,
    resolve_frustum_mode, set_fp32_numerics,
)
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, synthetic_stream,
)
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid

SCORED_SCALES = (0, 2)  # refined scale-0 map, fused-head scale-2 map


def score(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray,
          min_depth: float = 0.3, max_depth: float = 5.0) -> dict:
    """Offline metrics (reference metric.py:4-259) over pixels where both
    maps lie in (min_depth, max_depth)."""
    gt = np.where(mask, gt, 0.0)
    valid = ((pred > min_depth) & (pred < max_depth) & (gt > min_depth)
             & (gt < max_depth) & np.isfinite(pred) & np.isfinite(gt))
    p, g = pred[valid].astype(np.float64), gt[valid].astype(np.float64)
    if p.size == 0:
        return {}
    log_diff = np.log(p) - np.log(g)
    return {
        "abs_relative": float(np.mean(np.abs(p - g) / g)),
        "sq_relative": float(np.mean(np.square(p - g) / g)),
        "rmse": float(np.sqrt(np.mean(np.square(p - g)))),
        "rmse_log": float(np.sqrt(np.mean(np.square(log_diff)))),
        "ratio_threshold_1.25": float(np.mean(np.abs(log_diff)
                                              < np.log(1.25))),
    }


def run_scene(runner: ESTMRunner, frames: list, lwindow: int):
    """Stream one scene; returns per-output seconds (push + fetch of the
    scored maps), the fetched maps [2, H, W], and their scores against the
    window's centre frame (eval_hybrid_seq.py:202)."""
    runner.reset()
    times, maps, errs = [], [], []
    for idx, f in enumerate(frames):
        t0 = time.perf_counter()
        out = runner.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
        if out is None:
            continue
        depth = out[0].float().cpu().numpy()  # waits for the step
        times.append(time.perf_counter() - t0)
        maps.append(depth)
        centre = frames[idx - lwindow + 1 + lwindow // 2]
        errs.append(score(depth[0], centre["dmap"], centre["dmask"]))
    return times, maps, errs


def run_synthetic(height: int = 256, width: int = 320, ndepths: int = 64,
                  depth_min: float = 0.01, depth_max: float = 10.0,
                  resnet: int = 50, lwindow: int = 3, memory_size: int = 2,
                  scenes: int = 2, n_frames: int = 12, seed: int = 0,
                  device=None, frustum_mode: str = "plane_mix_exact_z",
                  fused_attention: bool = False) -> dict:
    """ESTM streaming over synthetic scenes (seeds 0..scenes-1) with random
    weights from `seed`.

    Returns {"times": seconds per output frame, "maps": per-frame
    [2, H, W] (refined, fused) depth, "errors": per-frame metrics}."""
    dev = resolve_device(device)
    set_fp32_numerics()
    model = DepthNetHybrid(ModelConfig(
        ndepths=ndepths, depth_min=depth_min, depth_max=depth_max,
        resnet=resnet, frustum_mode=frustum_mode,
        use_fused_attention=fused_attention), seed=seed)
    runner = ESTMRunner(model, height, width, lwindow, memory_size,
                        output_scales=SCORED_SCALES, device=dev)
    times, maps, errs = [], [], []
    for scene_seed in range(scenes):
        cfg = SyntheticSceneConfig(height=height, width=width,
                                   seed=scene_seed)
        frames = list(synthetic_stream(cfg, n_frames, depth_min, depth_max))
        t, m, e = run_scene(runner, frames, lwindow)
        times += t
        maps += m
        errs += e
    return {"times": times, "maps": maps, "errors": errs}


def parse_args(argv=None):
    ev, mc = EvalConfig(), ModelConfig()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--synthetic", action="store_true", required=True,
                   help="stream the synthetic scenes (the only data source "
                        "ported so far)")
    p.add_argument("--height", type=int, default=ev.height)
    p.add_argument("--width", type=int, default=ev.width)
    p.add_argument("--ndepths", type=int, default=mc.ndepths)
    p.add_argument("--depth-min", type=float, default=mc.depth_min)
    p.add_argument("--depth-max", type=float, default=mc.depth_max)
    p.add_argument("--resnet", type=int, default=mc.resnet)
    p.add_argument("--lwindow", type=int, default=ev.lwindow)
    p.add_argument("--memory-size", type=int, default=ev.memory_size)
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--frames", type=int, default=12)
    add_model_flags(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    res = run_synthetic(
        args.height, args.width, args.ndepths, args.depth_min,
        args.depth_max, args.resnet, args.lwindow, args.memory_size,
        args.scenes, args.frames, args.seed, args.device,
        resolve_frustum_mode(args.exact_warp, args.exact_z),
        args.fused_attention)
    steady = res["times"][4:] or res["times"]
    print(f"{len(res['times'])} frames; inference time: "
          f"{np.mean(steady):.4f}s ({1.0 / np.mean(steady):.2f} fps)")
    errs = [e for e in res["errors"] if e]
    if errs:
        means = {k: float(np.mean([e[k] for e in errs])) for k in errs[0]}
        print("metrics:", " ".join(f"{k}={v:.4f}" for k, v in means.items()))


if __name__ == "__main__":
    main()
