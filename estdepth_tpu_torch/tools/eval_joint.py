"""Joint-mode evaluation on the port (counterpart of tools/eval_joint.py;
reference eval_hybrid.py).

    python -m estdepth_tpu_torch.tools.eval_joint --synthetic [--scan]
        [--no-exact-z | --exact-warp] [--fused-attention]

Windows of --seq-length frames (5) advance by seq_length-2 frames so their
targets tile the video: 5 frames in, 3 depth maps out. The last target's
detached key/value volume threads to the next window as a 1-entry EST
memory (eval_hybrid.py:229-243); the first window runs without EST. With
--scan the same chain runs through eval/sequence.make_joint_processor: the
scene is uploaded once and the matching features of every frame are
computed once. Reports the time per window and the offline metrics of the
refined (scale 0) depth against the synthetic ground truth. Weights are
random from --seed. Runs on the CUDA device unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from estdepth_tpu_torch.config import (
    EvalConfig, ModelConfig, add_model_flags, resolve_device,
    resolve_frustum_mode, set_fp32_numerics,
)
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, synthetic_window,
)
from estdepth_tpu_torch.eval.sequence import make_joint_processor
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.models.memory import ESTMemory
from estdepth_tpu_torch.tools.eval_estm import SCORED_SCALES, score


class JointRunner:
    """Chains the windows of one scene, threading the last target's state
    as a 1-entry memory (eval_hybrid.py:229-243). The model is moved to
    `device` (None: the CUDA device, raising when there is none)."""

    def __init__(self, model: DepthNetHybrid, est_on: bool = True,
                 return_probs: bool = False,
                 reference_pose_pairing: bool = False, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.est_on = est_on
        self.return_probs = return_probs
        self.reference_pose_pairing = reference_pose_pairing
        self.memory: ESTMemory | None = None

    def reset(self) -> None:
        self.memory = None

    @torch.inference_mode()
    def run_window(self, imgs, poses, intr):
        """imgs [B, V, H, W, 3] (0..255), poses [B, V, 4, 4], intr
        [B, 3, 3], numpy or tensors -> (depth [B, T, 4, H, W] on the
        device, probs [B, T, 2, H, W] (init, fused) or None)."""
        dev = self.device
        imgs = torch.as_tensor(imgs).to(dev)
        poses = torch.as_tensor(poses).float().to(dev)
        intr = torch.as_tensor(intr).float().to(dev)
        use_est = self.est_on and self.memory is not None
        outputs, (key, value, pose) = self.model(
            imgs, poses, intr, memory=self.memory if use_est else None,
            use_est=use_est)
        if self.reference_pose_pairing and use_est:
            # the reference's bookkeeping: its decoder extends cam_poses
            # with the memory's poses BEFORE returning cam_poses[-1:]
            # (hybrid_depth_decoder.py:221,292), so with a threaded 1-entry
            # memory the stored pose stays window 0's last-target pose
            pose = self.memory.poses[:, -1]
        self.memory = ESTMemory(
            keys=key[:, None], values=value[:, None], poses=pose[:, None],
            valid=torch.ones(key.shape[0], 1, dtype=torch.bool, device=dev))
        probs = None
        if self.return_probs:
            probs = torch.stack([outputs["init_prob"],
                                 outputs["fused_prob"]], 2)
        return outputs["depth"], probs


def run_synthetic(height: int = 256, width: int = 320, ndepths: int = 64,
                  depth_min: float = 0.01, depth_max: float = 10.0,
                  resnet: int = 50, seq_length: int = 5, windows: int = 3,
                  est_on: bool = True, scan: bool = False,
                  frustum_mode: str = "plane_mix_exact_z",
                  fused_attention: bool = False, seed: int = 0,
                  device=None) -> dict:
    """The Joint chain over one synthetic scene of
    (windows-1)*(seq_length-2) + seq_length frames, random weights from
    `seed`.

    Returns {"times": seconds per window (one entry for the whole chain
    with `scan`), "maps": [windows, T, 2, H, W] (refined, fused) depth,
    "errors": per-target metrics of the refined map}."""
    dev = resolve_device(device)
    set_fp32_numerics()
    model = DepthNetHybrid(ModelConfig(
        ndepths=ndepths, depth_min=depth_min, depth_max=depth_max,
        resnet=resnet, frustum_mode=frustum_mode,
        use_fused_attention=fused_attention), seed=seed)
    cfg = SyntheticSceneConfig(height=height, width=width)
    stride = seq_length - 2
    samples = [synthetic_window(cfg, seq_length, wi * stride, depth_min,
                                depth_max) for wi in range(windows)]
    times = []
    if scan:
        # the windows' frames as one sampled sequence
        seq = {k: np.concatenate(
            [samples[0][k]] + [s[k][:, -stride:] for s in samples[1:]], 1)
            for k in ("imgs", "cam_poses")}
        proc = make_joint_processor(model, seq_length, est_on,
                                    output_scales=SCORED_SCALES, device=dev)
        t0 = time.perf_counter()
        maps = proc(seq["imgs"], seq["cam_poses"],
                    samples[0]["cam_intr"])[0].float().cpu().numpy()
        times.append(time.perf_counter() - t0)
    else:
        runner = JointRunner(model, est_on, device=dev)
        maps = []
        for sample in samples:
            t0 = time.perf_counter()
            depth, _ = runner.run_window(sample["imgs"], sample["cam_poses"],
                                         sample["cam_intr"])
            # the fetch waits for the window
            maps.append(depth[0][:, list(SCORED_SCALES)].cpu().numpy())
            times.append(time.perf_counter() - t0)
        maps = np.stack(maps)
    errs = [score(maps[wi, ti, 0], s["dmaps"][0, ti], s["dmasks"][0, ti])
            for wi, s in enumerate(samples) for ti in range(stride)]
    return {"times": times, "maps": maps, "errors": errs}


def parse_args(argv=None):
    ev, mc = EvalConfig(), ModelConfig()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--synthetic", action="store_true", required=True,
                   help="evaluate the synthetic scene (the only data source "
                        "ported so far)")
    p.add_argument("--height", type=int, default=ev.height)
    p.add_argument("--width", type=int, default=ev.width)
    p.add_argument("--ndepths", type=int, default=mc.ndepths)
    p.add_argument("--depth-min", type=float, default=mc.depth_min)
    p.add_argument("--depth-max", type=float, default=mc.depth_max)
    p.add_argument("--resnet", type=int, default=mc.resnet)
    p.add_argument("--seq-length", type=int, default=5)
    p.add_argument("--no-est", action="store_true",
                   help="the pure stereo path in every window")
    p.add_argument("--scan", action="store_true",
                   help="the whole chain through make_joint_processor")
    add_model_flags(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    res = run_synthetic(
        args.height, args.width, args.ndepths, args.depth_min,
        args.depth_max, args.resnet, args.seq_length,
        est_on=not args.no_est, scan=args.scan,
        frustum_mode=resolve_frustum_mode(args.exact_warp, args.exact_z),
        fused_attention=args.fused_attention, seed=args.seed,
        device=args.device)
    targets = res["maps"].shape[0] * res["maps"].shape[1]
    total = sum(res["times"])
    print(f"{res['maps'].shape[0]} windows, {targets} target frames in "
          f"{total:.3f}s ({targets / total:.2f} targets/s)")
    errs = [e for e in res["errors"] if e]
    if errs:
        means = {k: float(np.mean([e[k] for e in errs])) for k in errs[0]}
        print("metrics:", " ".join(f"{k}={v:.4f}" for k, v in means.items()))


if __name__ == "__main__":
    main()
