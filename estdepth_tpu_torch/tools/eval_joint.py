"""Joint-mode evaluation on the port (counterpart of tools/eval_joint.py;
reference eval_hybrid.py).

    python -m estdepth_tpu_torch.tools.eval_joint --synthetic [--scan]
        [--no-exact-z | --exact-warp] [--fused-attention]
    python -m estdepth_tpu_torch.tools.eval_joint --datapath DIR
        [--testlist FILE] [--eval-dataset scannet|7scenes] [--ckpt PATH]
        [--outdir DIR] [--save-maps] [--save-probs] [--eval-all]
        [--keyframe-list FILE] [--max-windows N] [--scan [--scene-batch N]]

Windows of --seq-length frames (5), spaced --frame-interval frames apart,
advance by seq_length-2 frames so their targets tile the video: 5 frames
in, 3 depth maps out; windows holding a non-finite pose are skipped, and
--eval-all adds the windows of every start offset. The last target's
detached key/value volume threads to the next window as a 1-entry EST
memory (eval_hybrid.py:229-243); the first window runs without EST. With
--scan the same chain runs through eval/sequence.make_joint_processor: the
scene is uploaded once and the matching features of every frame are
computed once, and --scene-batch N scenes go through one batched call; a
scene whose windows are not a gapless grid takes the window loop and
stays out of the group, and --eval-all, --keyframe-list and --save-probs
fall back to the window loop.
--keyframe-list evaluates independent windows around listed (scene,
index) keyframes, with no memory between them.

Each target's refined (scale 0) depth is scored against its ground truth
at the GT's own resolution; --save-maps writes float16
`{scene}_{window:04d}_{target}_depth.npy` (refined) and `_init.npy` (fused
head, scale 2) plus a colorized image, --save-probs the init and refined
probability maps. A scene whose maps are already in --outdir is skipped.
Data, weights (--ckpt), the warp flags and --bf16 as in
tools/eval_estm.py; with --synthetic, one synthetic scene of --max-windows
windows (3). Runs on the CUDA device unless --device cpu is given.

Spans (utils/trace.py): `JointRunner.run_window` runs inside `step`, its
copies of the window to the device inside `host_wait.upload` (pageable
host memory: on CUDA each waits for the device's queue to drain).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from estdepth_tpu_torch.config import (
    EvalConfig, ModelConfig, add_model_flags, resolve_device,
    set_fp32_numerics,
)
from estdepth_tpu_torch.data.eval_windows import WindowEvalDataset
from estdepth_tpu_torch.data.keyframe_eval import KeyframeEvalDataset
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, synthetic_window,
)
from estdepth_tpu_torch.eval.sequence import make_joint_processor
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.models.memory import ESTMemory
from estdepth_tpu_torch.tools.eval_estm import (
    SCORED_SCALES, add_result, build_model, maps_exist, new_result,
    print_summary, save_maps, scene_list, score, timed_frames,
)
from estdepth_tpu_torch.utils import trace
from estdepth_tpu_torch.utils.viz import colorize_probmap, save_image


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

    @trace.spanned("step")
    @torch.inference_mode()
    def run_window(self, imgs, poses, intr):
        """imgs [B, V, H, W, 3] (0..255), poses [B, V, 4, 4], intr
        [B, 3, 3], numpy or tensors -> (depth [B, T, 4, H, W] on the
        device, probs [B, T, 2, H, W] (init, fused) or None)."""
        dev = self.device
        with trace.host_wait("upload"):
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


def _save_target(base: str, maps: np.ndarray, probs, args) -> None:
    """One target's outputs: maps [2, H, W] (refined, fused head), probs
    [2, H, W] (init, refined) or None. --save-maps and --save-probs are
    independent, like the reference's save_*_depth / save_*_prob flags
    (eval_hybrid.py:59-62)."""
    if args.save_maps:
        save_maps(base, maps[0], maps[1], args.depth_min, args.depth_max)
    if args.save_probs and probs is not None:
        for pmap, kind in zip(probs, ("init_prob", "refined_prob")):
            np.save(f"{base}_{kind}.npy", pmap.astype(np.float16))
            save_image(f"{base}_{kind}.jpg", colorize_probmap(pmap))


def _score_and_save(res: dict, maps: np.ndarray, probs, gts, name: str,
                    wi: int, args, outdir) -> None:
    """Score and save the targets of window wi: maps [T, 2, H, W], probs
    [T, 2, H, W] or None, gts[t] = (gt, mask) or None."""
    for ti in range(maps.shape[0]):
        t0 = time.perf_counter()
        if gts[ti] is not None:
            res["errors"].append(score(maps[ti, 0], *gts[ti]))
        t1 = time.perf_counter()
        if outdir:
            _save_target(os.path.join(outdir, f"{name}_{wi:04d}_{ti}"),
                         maps[ti], None if probs is None else probs[ti],
                         args)
        res["host"]["score"] += t1 - t0
        res["host"]["save"] += time.perf_counter() - t1


def eval_windows(runner: JointRunner, windows, name: str, args, outdir=None,
                 keep_maps: bool = False) -> dict:
    """The window loop over one scene (a fresh memory, threaded from each
    window to the next): each window's targets scored and saved. A
    window's time runs from its upload to the fetch of its maps."""
    runner.reset()
    res = new_result()
    start = time.perf_counter()
    for wi, sample in enumerate(timed_frames(windows, res["host"])):
        t0 = time.perf_counter()
        depth, probs = runner.run_window(sample["imgs"], sample["cam_poses"],
                                         sample["cam_intr"])
        # the two maps the reference saves per target (eval_hybrid.py:
        # 259-308); the fetch waits for the window
        maps = depth[0][:, list(SCORED_SCALES)].cpu().numpy()
        probs = None if probs is None else probs[0].cpu().numpy()
        res["times"].append(time.perf_counter() - t0)
        gts = [(sample["dmaps"][0, ti], sample["dmasks"][0, ti])
               if "dmaps" in sample else None for ti in range(len(maps))]
        _score_and_save(res, maps, probs, gts, name, wi, args, outdir)
        if keep_maps:
            res["maps"].append(maps)
        if args.max_windows and wi + 1 >= args.max_windows:
            break
    res["seconds"] = time.perf_counter() - start
    return res


def scan_scenes(proc, group: list, args, outdir=None,
                keep_maps: bool = False) -> dict:
    """A group of scenes through one make_joint_processor call.

    group: [(name, seq, gt_fn)] with seq as WindowEvalDataset.sequence
    gives it (imgs [T, H, W, 3], cam_poses [T, 4, 4], cam_intr [3, 3],
    n_windows) and gt_fn(k) -> (gt, mask) or None for sampled frame k.
    Each scene's frames are cut or padded to the group's largest window
    count (the last frame repeated) and the padded windows' outputs
    dropped; the batch axis never mixes, so each scene's maps are its own
    chain's. One time entry for the whole group."""
    res = new_result()
    start = time.perf_counter()
    stride = args.seq_length - 2
    nws = [seq["n_windows"] for _, seq, _ in group]
    t = (max(nws) - 1) * stride + args.seq_length

    def pad_t(x):
        x = x[:t]
        return np.concatenate([x, np.repeat(x[-1:], t - len(x), 0)])

    depths = proc(np.stack([pad_t(seq["imgs"]) for _, seq, _ in group]),
                  np.stack([pad_t(seq["cam_poses"]) for _, seq, _ in group]),
                  np.stack([seq["cam_intr"] for _, seq, _ in group])
                  ).cpu().numpy()  # [B, max(nws), T, 2, H, W]
    dt = time.perf_counter() - start
    res["times"].append(dt)
    n_targets = sum(nws) * stride
    print(f"scan group of {len(group)}: {n_targets} target frames in "
          f"{dt:.1f}s ({n_targets / dt:.2f} targets/s, program "
          f"windows={max(nws)})")
    for (name, _, gt_fn), scene, nw in zip(group, depths, nws):
        for wi, maps in enumerate(scene[:nw]):  # [T, 2, H, W] per window
            _score_and_save(res, maps, None, [
                gt_fn(wi * stride + 1 + ti) for ti in range(stride)], name,
                wi, args, outdir)
            if keep_maps:
                res["maps"].append(maps)
    res["seconds"] = time.perf_counter() - start
    return res


def _synthetic(runner, proc, args, keep_maps: bool) -> dict:
    """One synthetic scene of --max-windows windows (3)."""
    cfg = SyntheticSceneConfig(height=args.height, width=args.width)
    stride = args.seq_length - 2
    samples = [synthetic_window(cfg, args.seq_length, wi * stride,
                                args.depth_min, args.depth_max)
               for wi in range(args.max_windows or 3)]
    if proc is None:
        return eval_windows(runner, samples, "synthetic", args, args.outdir,
                            keep_maps)
    # the windows' frames as one sampled sequence
    seq = {k: np.concatenate(
        [samples[0][k][0]] + [s[k][0, -stride:] for s in samples[1:]])
        for k in ("imgs", "cam_poses")}
    seq.update(cam_intr=samples[0]["cam_intr"][0], n_windows=len(samples))

    def gt_fn(k):  # sampled frame k is target (k - 1) % stride of window
        wi, ti = divmod(k - 1, stride)
        return samples[wi]["dmaps"][0, ti], samples[wi]["dmasks"][0, ti]

    return scan_scenes(proc, [("synthetic", seq, gt_fn)], args, args.outdir,
                       keep_maps)


def run(args, keep_maps: bool = False) -> dict:
    """The tool: every window of the flags through the model. Returns
    eval_estm.new_result()'s fields over all scenes (maps [T, 2, H, W] per
    window, refined and fused, only with keep_maps)."""
    dev = resolve_device(args.device)
    set_fp32_numerics()
    if not (args.synthetic or args.datapath):
        raise SystemExit("need --datapath or --synthetic")
    model = build_model(args)
    if args.scan and (args.save_probs or args.keyframe_list
                      or args.eval_all):
        print("note: --scan does not cover --save-probs/--keyframe-list/"
              "--eval-all; using the window loop")
        args.scan = False
    est_on = not args.no_est
    proc = None
    if args.scan:
        proc = make_joint_processor(model, args.seq_length, est_on,
                                    output_scales=SCORED_SCALES, device=dev)
    runner = JointRunner(model, est_on, return_probs=args.save_probs,
                         device=dev)
    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
    total = new_result()
    if args.keyframe_list:
        ds = KeyframeEvalDataset(
            args.datapath, args.keyframe_list, args.height, args.width,
            depth_min=max(args.depth_min, 0.1), depth_max=args.depth_max)
        for i in range(len(ds)):
            # keyframe windows are independent: no cross-window state
            sample = ds[i]
            add_result(total, eval_windows(
                runner, [sample], f"{sample['scene']}_{sample['index']}",
                args, args.outdir, keep_maps))
        print(f"keyframes: {len(ds)} windows")
    elif args.synthetic:
        add_result(total, _synthetic(runner, proc, args, keep_maps))
    else:
        ds = WindowEvalDataset(
            args.datapath, args.height, args.width, depth_min=0.3,
            depth_max=5.0, seq_length=args.seq_length,
            frame_interval=args.frame_interval,
            scannet_layout=args.eval_dataset == "scannet",
            eval_all=args.eval_all)
        group = []  # --scan: scenes queued for one processor call

        def flush():
            add_result(total, scan_scenes(proc, group, args, args.outdir,
                                          keep_maps))
            group.clear()

        for scene, seq in scene_list(args):
            name = scene if seq is None else f"{scene}_{seq}"
            if args.save_maps and maps_exist(args.outdir, name):
                print(f"{name}: outputs exist, skipping")
                continue
            ds.reset(scene, seq)
            sq = ds.sequence(args.max_windows) if args.scan else None
            if sq is not None and sq["window_stride"] == args.seq_length - 2:
                group.append((name, sq, lambda k, p=sq["dmap_paths"]:
                              ds.read_gt(p[k])))
                if len(group) == args.scene_batch:
                    flush()
                continue
            if args.scan:
                print(f"{name}: window chain is not a gapless grid; "
                      "loop fallback")
            res = eval_windows(runner, (ds[i] for i in range(len(ds))),
                               name, args, args.outdir, keep_maps)
            add_result(total, res)
            print(f"{name}: {len(res['errors'])} target frames")
        if group:  # the partial last group, at its own size
            flush()
    return total


def run_synthetic(height: int = 256, width: int = 320, ndepths: int = 64,
                  depth_min: float = 0.01, depth_max: float = 10.0,
                  resnet: int = 50, seq_length: int = 5, windows: int = 3,
                  est_on: bool = True, scan: bool = False,
                  frustum_mode: str = "plane_mix_exact_z",
                  fused_attention: bool = False, seed: int = 0,
                  device=None, compute_dtype: str = "float32") -> dict:
    """The Joint chain over one synthetic scene of
    (windows-1)*(seq_length-2) + seq_length frames, random weights from
    `seed`, through the tool's own loop.

    Returns {"times": seconds per window (one entry for the whole chain
    with `scan`), "maps": [windows, T, 2, H, W] (refined, fused) depth,
    "errors": per-target metrics of the refined map}."""
    args = parse_args(["--synthetic"])
    vars(args).update(
        height=height, width=width, ndepths=ndepths, depth_min=depth_min,
        depth_max=depth_max, resnet=resnet, seq_length=seq_length,
        max_windows=windows, no_est=not est_on, scan=scan, seed=seed,
        device=device, exact_warp=frustum_mode == "exact",
        exact_z=frustum_mode == "plane_mix_exact_z",
        fused_attention=fused_attention, bf16=compute_dtype == "bfloat16")
    res = run(args, keep_maps=True)
    return {"times": res["times"], "maps": np.stack(res["maps"]),
            "errors": res["errors"]}


def parse_args(argv=None):
    ev, mc = EvalConfig(), ModelConfig()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--datapath", type=str, default=None)
    p.add_argument("--testlist", type=str, default=None)
    p.add_argument("--eval-dataset", choices=["scannet", "7scenes"],
                   default="scannet")
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate a synthetic scene instead of a dataset")
    p.add_argument("--outdir", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None,
                   help="a reference checkpoint (.ckpt/.pth/.pt/.tar) or a "
                        "checkpoint directory of tools/train.py")
    p.add_argument("--height", type=int, default=ev.height)
    p.add_argument("--width", type=int, default=ev.width)
    p.add_argument("--ndepths", type=int, default=mc.ndepths)
    p.add_argument("--depth-min", type=float, default=mc.depth_min)
    p.add_argument("--depth-max", type=float, default=mc.depth_max)
    p.add_argument("--resnet", type=int, default=mc.resnet)
    p.add_argument("--seq-length", type=int, default=5)
    p.add_argument("--frame-interval", type=int, default=10)
    p.add_argument("--eval-all", action="store_true",
                   help="windows from every start offset (reference "
                        "--eval_all, general_eval.py:46-50)")
    p.add_argument("--no-est", action="store_true",
                   help="the pure stereo path in every window")
    p.add_argument("--keyframe-list", type=str, default=None,
                   help="evaluate (scene, index) keyframe windows "
                        "(ScannetTestDataset mode, scannet_select.py)")
    p.add_argument("--max-windows", type=int, default=None,
                   help="windows per scene (with --synthetic: the scene's "
                        "windows, default 3)")
    p.add_argument("--save-maps", action="store_true")
    p.add_argument("--save-probs", action="store_true",
                   help="also write each target's init and refined "
                        "probability maps")
    p.add_argument("--scan", action="store_true",
                   help="the whole chain through make_joint_processor")
    p.add_argument("--scene-batch", type=int, default=1,
                   help="with --scan: evaluate this many independent scenes "
                        "per make_joint_processor call, each padded to the "
                        "group's longest window chain (the batch axis never "
                        "mixes). The partial last group runs at its own "
                        "size (the JAX tool pads it to avoid a recompile, "
                        "which PyTorch does not have)")
    add_model_flags(p)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights without --ckpt")
    p.add_argument("--device", type=str, default=None)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    print("args:", vars(args))
    res = run(args)
    if res["times"]:
        targets, total = len(res["errors"]), sum(res["times"])
        print(f"{targets} target frames in {total:.3f}s "
              f"({targets / total:.2f} targets/s)")
    print_summary([], res["errors"])


if __name__ == "__main__":
    main()
