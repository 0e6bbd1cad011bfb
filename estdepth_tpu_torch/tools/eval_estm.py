"""ESTM streaming evaluation on the port (counterpart of tools/eval_estm.py;
reference eval_hybrid_seq.py).

    python -m estdepth_tpu_torch.tools.eval_estm --synthetic
    python -m estdepth_tpu_torch.tools.eval_estm --datapath DIR
        [--testlist FILE] [--eval-dataset scannet|7scenes] [--ckpt PATH]
        [--outdir DIR --save-maps | --reference-layout]
        [--scan [--scene-batch N]]

Per scene, every --frame-interval-th frame with a finite pose (from
--start-index) streams through ESTMRunner (lwindow 3, memory 2 by
default), or with --scan through the chunked SequenceProcessor, each
group of --scene-batch scenes in one batched call, and each window yields
the depth of its centre frame. That depth is scored against
the frame's ground truth at the GT's own resolution (the prediction is
resized to it, then eval/metric_offline.compute_errors), and with
--save-maps written as float16 `{scene}_{idx:06d}_depth.npy` (refined,
scale 0) and `_init.npy` (fused head, scale 2) plus a colorized image;
--reference-layout writes the reference's tree
`<scene>/{init,refined}_{depth,prob}/<idx>.npy` instead. A scene whose
maps are already in --outdir is skipped. Prints the mean time per frame
and the mean metrics.

Streaming runs a one-frame-deep fetch pipeline: frame t's maps are copied
to pinned host memory behind its step, and read, scored and saved once
frame t+1's step is queued, so that host work overlaps the device.

Data: --synthetic (--scenes synthetic scenes of --frames frames, ground
truth rendered at the output resolution), or --datapath in the ScanNet
layout (<scene>/{rgb,depth,pose}/<i>.*; scenes from --testlist, else every
directory) or the 7-Scenes layout (--eval-dataset 7scenes: its 18 test
sequences). Without OpenCV only PNG frames can be read. Weights: random
from --seed, or --ckpt, a reference checkpoint (.ckpt/.pth/.pt/.tar) or a
directory written by tools/train.py (its latest step). The defaults are
the JAX tool's: 256x320 frames, 64 planes in [0.01, 10] m, ResNet-50.
--no-exact-z, --exact-warp and --fused-attention pick the frustum warp and
the attention kernel; --bf16 runs the model in bfloat16, and --fetch-half
fetches the scored maps as bfloat16. Runs on the CUDA device unless
--device cpu is given.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from estdepth_tpu_torch.config import (
    EvalConfig, ModelConfig, add_model_flags, compute_dtype_flag,
    resolve_device, resolve_frustum_mode, set_fp32_numerics,
)
from estdepth_tpu_torch.data import io_utils
from estdepth_tpu_torch.data.eval_stream import StreamEvalDataset
from estdepth_tpu_torch.data.eval_windows import SEVEN_SCENES_TEST_SEQS
from estdepth_tpu_torch.data.synthetic import (
    SyntheticSceneConfig, synthetic_stream,
)
from estdepth_tpu_torch.eval.estm import ESTMRunner
from estdepth_tpu_torch.eval.output import to_numpy
from estdepth_tpu_torch.eval.metric_offline import compute_errors
from estdepth_tpu_torch.eval.sequence import SequenceProcessor
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.utils.checkpoint import (
    CheckpointManager, load_weights_for_finetune,
)
from estdepth_tpu_torch.utils.convert import load_reference_checkpoint
from estdepth_tpu_torch.utils.viz import (
    colorize_depth, colorize_probmap, save_image,
)

SCORED_SCALES = (0, 2)  # refined scale-0 map, fused-head scale-2 map
METRIC_KEYS = ("abs_relative", "sq_relative", "rmse", "rmse_log",
               "ratio_threshold_1.25")
# host seconds of a scene: reading frames and ground truth, scoring, saving
HOST_KEYS = ("read", "score", "save")


def build_model(args) -> DepthNetHybrid:
    """The model of the flags, with random weights from --seed or the
    weights of --ckpt."""
    model = DepthNetHybrid(ModelConfig(
        ndepths=args.ndepths, depth_min=args.depth_min,
        depth_max=args.depth_max, resnet=args.resnet,
        frustum_mode=resolve_frustum_mode(args.exact_warp, args.exact_z),
        use_fused_attention=args.fused_attention,
        compute_dtype=compute_dtype_flag(args)), seed=args.seed)
    if args.ckpt:
        if args.ckpt.endswith((".ckpt", ".pth", ".pt", ".tar")):
            state, unmatched = load_reference_checkpoint(args.ckpt,
                                                         strict=False)
            if unmatched:
                print(f"converter skipped {len(unmatched)} torch keys")
            model.load_state_dict(state)
            print(f"converted torch checkpoint {args.ckpt}")
        else:  # a checkpoint directory of tools/train.py
            model.load_state_dict(load_weights_for_finetune(args.ckpt))
            print(f"restored checkpoint step "
                  f"{CheckpointManager(args.ckpt).latest_step()} from "
                  f"{args.ckpt}")
    return model


def score(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> dict:
    """Resize pred to the GT's resolution (cv2's INTER_LINEAR) and compute
    the offline metric suite (the reference's metric.py)."""
    pred_up = io_utils.resize(np.asarray(pred, np.float32), gt.shape[1],
                              gt.shape[0])
    return compute_errors(pred_up, np.where(mask, gt, 0.0))


def scene_list(args) -> list:
    """(scene, sequence or None) pairs of a dataset: the ScanNet scenes of
    --testlist (else every directory under --datapath), or the 7-Scenes
    test sequences."""
    if args.eval_dataset == "7scenes":
        return list(SEVEN_SCENES_TEST_SEQS)
    scenes = (io_utils.read_split_file(args.testlist) if args.testlist
              else sorted(os.listdir(args.datapath)))
    return [(s, None) for s in scenes]


def maps_exist(outdir, name: str) -> bool:
    """Skip-completed-scenes resume (eval_hybrid_seq.py:289-290)."""
    return bool(outdir) and bool(
        glob.glob(os.path.join(outdir, f"{name}_*_depth.npy")))


def save_maps(base: str, refined: np.ndarray, init: np.ndarray,
              depth_min: float, depth_max: float) -> None:
    """The two maps the reference saves per frame, as float16, and the
    colorized refined map."""
    np.save(base + "_depth.npy", refined.astype(np.float16))
    np.save(base + "_init.npy", init.astype(np.float16))
    save_image(base + "_depth.jpg",
               colorize_depth(refined, depth_min, depth_max))


def _write_reference_layout(outdir, scene, idx, refined, init, probs,
                            depth_max):
    """Reference output tree: <outdir>/<scene>/{init_depth,init_prob,
    refined_depth,refined_prob}/<frame>.npy + colorized image
    (eval_hybrid_seq.py:144-156,200-258). The reference's naming: its
    'init_depth' is the fused scale-2 head, 'refined_depth' is scale 0."""
    maps = {
        "init_depth": (init, "depth"),
        "refined_depth": (refined, "depth"),
        "init_prob": (probs[0, 0], "prob"),
        "refined_prob": (probs[0, 1], "prob"),
    }
    for kind, (arr, flavor) in maps.items():
        d = os.path.join(outdir, scene, kind)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{idx:06d}.npy"), arr.astype(np.float16))
        img = (colorize_depth(arr, 0.0, min(depth_max, 5.0))
               if flavor == "depth" else colorize_probmap(arr))
        save_image(os.path.join(d, f"{idx:06d}.jpg"), img)


def new_result() -> dict:
    """What a scene's evaluation returns: seconds per output frame (or
    window), the fetched maps when kept, the metrics per target, host
    seconds by HOST_KEYS, and the wall seconds of the scene."""
    return {"times": [], "maps": [], "errors": [],
            "host": dict.fromkeys(HOST_KEYS, 0.0), "seconds": 0.0}


def add_result(total: dict, res: dict) -> None:
    for k in ("times", "maps", "errors"):
        total[k] += res[k]
    for k in HOST_KEYS:
        total["host"][k] += res["host"][k]
    total["seconds"] += res["seconds"]


def timed_frames(frames, host: dict):
    """The items of `frames`, the time spent producing each (reading and
    decoding) added to host["read"]."""
    frames = iter(frames)
    while True:
        t0 = time.perf_counter()
        item = next(frames, None)
        host["read"] += time.perf_counter() - t0
        if item is None:
            return
        yield item


def _start_fetch(out):
    """Queue the device->host copy of `out` (a tensor, or a tuple of them)
    behind the work that computes it; returns a function that waits for
    that copy alone and gives the numpy arrays."""
    tensors = out if isinstance(out, tuple) else (out,)

    def arrays(hosts):
        return tuple(hosts) if isinstance(out, tuple) else hosts[0]

    if tensors[0].device.type != "cuda":
        hosts = [to_numpy(t) for t in tensors]
        return lambda: arrays(hosts)
    pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
              for t in tensors]
    for h, t in zip(pinned, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return arrays([to_numpy(h) for h in pinned])

    return wait


def run_scene(runner: ESTMRunner, frames, args, outdir=None, scene="",
              keep_maps: bool = False) -> dict:
    """Streaming eval of one scene with a one-frame-deep fetch pipeline:
    frame t's step is queued, THEN frame t-1's maps are read, scored and
    saved while t computes on the device. A frame's time runs from its
    push to the end of the previous frame's scoring and saving."""
    res = new_result()
    lw = args.lwindow
    start = time.perf_counter()

    def consume(pending):
        fetch, cidx, cf = pending
        out = fetch()
        depth, probs = out if isinstance(out, tuple) else (out, None)
        refined, init = depth[0, 0], depth[0, 1]
        if keep_maps:
            res["maps"].append(depth[0].copy())
        t0 = time.perf_counter()
        if cf.get("dmap") is not None:
            res["errors"].append(score(refined, cf["dmap"], cf["dmask"]))
        t1 = time.perf_counter()
        if outdir and args.reference_layout and probs is not None:
            _write_reference_layout(outdir, scene, cidx, refined, init,
                                    probs, args.depth_max)
        elif outdir and args.save_maps:
            save_maps(os.path.join(outdir, f"{scene}_{cidx:06d}"), refined,
                      init, args.depth_min, args.depth_max)
        res["host"]["score"] += t1 - t0
        res["host"]["save"] += time.perf_counter() - t1

    runner.reset()
    pending = None  # (fetch, centre index, centre frame)
    window = []  # recent frames; the emitted depth is the CENTRE frame's
    emitted = 0
    for idx, f in enumerate(timed_frames(frames, res["host"])):
        window.append((idx, f))
        if len(window) > lw:
            window.pop(0)
        t0 = time.perf_counter()
        out = runner.push_frame(f["img"], f["cam_pose"], f["cam_intr"])
        fetch = _start_fetch(out) if out is not None else None
        if pending is not None:
            consume(pending)
            pending = None
        if fetch is not None:
            # the window's centre frame (eval_hybrid_seq.py:202)
            cidx, cf = window[lw // 2]
            pending = (fetch, cidx, cf)
            res["times"].append(time.perf_counter() - t0)
            emitted += 1
        if args.max_frames and emitted >= args.max_frames:
            break
    if pending is not None:
        consume(pending)
    res["seconds"] = time.perf_counter() - start
    return res


def read_scan_scene(frames, args, host: dict):
    """A scene's frames for --scan, read in full (the time added to
    host["read"]) and cut to --max-frames outputs; None when fewer than
    lwindow remain."""
    frames = list(timed_frames(frames, host))
    if args.max_frames:
        frames = frames[:args.max_frames + args.lwindow - 1]
    return frames if len(frames) >= args.lwindow else None


def run_scenes_scan(proc: SequenceProcessor, group: list, args, outdir=None,
                    keep_maps: bool = False) -> dict:
    """A group of scenes [(name, frames)] through one
    SequenceProcessor.process_scenes call (the batch axis never mixes, so
    each scene's maps are its streaming maps), then each scene's maps
    scored and saved as in streaming. Every output frame of
    the group is credited the group's mean time."""
    res = new_result()
    start = time.perf_counter()
    t0 = time.perf_counter()
    results = proc.process_scenes([(
        np.stack([f["img"] for f in frames]),
        np.stack([f["cam_pose"] for f in frames]).astype(np.float32),
        frames[0]["cam_intr"]) for _, frames in group])
    n_total = sum(len(d) for d in results)
    res["times"] = [(time.perf_counter() - t0) / n_total] * n_total
    for (scene, frames), depths in zip(group, results):
        print(f"{scene}: {len(depths)} windows (scan batch of {len(group)})")
        for wi, d in enumerate(depths):
            cidx = wi + args.lwindow // 2  # the window's centre frame
            f = frames[cidx]
            if keep_maps:
                res["maps"].append(d)
            t0 = time.perf_counter()
            if f.get("dmap") is not None:
                res["errors"].append(score(d[0], f["dmap"], f["dmask"]))
            t1 = time.perf_counter()
            if outdir and args.save_maps:
                save_maps(os.path.join(outdir, f"{scene}_{cidx:06d}"), d[0],
                          d[1], args.depth_min, args.depth_max)
            res["host"]["score"] += t1 - t0
            res["host"]["save"] += time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - start
    return res


def scenes(args):
    """(name, frames) of each scene to evaluate; the frames are read as
    they are iterated."""
    if args.synthetic:
        for seed in range(args.scenes):
            cfg = SyntheticSceneConfig(height=args.height, width=args.width,
                                       seed=seed)
            yield f"synthetic{seed}", synthetic_stream(
                cfg, args.frames, args.depth_min, args.depth_max)
        return
    ds = StreamEvalDataset(
        args.datapath, args.height, args.width, depth_min=args.depth_min,
        depth_max=min(args.depth_max, 5.0),
        frame_interval=args.frame_interval,
        scannet_layout=args.eval_dataset == "scannet",
        start_index=args.start_index)
    for scene, seq in scene_list(args):
        name = scene if seq is None else f"{scene}_{seq}"
        if args.save_maps and maps_exist(args.outdir, name):
            print(f"{name}: outputs exist, skipping")
            continue
        ds.reset(scene, seq)
        yield name, iter(ds)


def run(args, keep_maps: bool = False) -> dict:
    """The tool: every scene of the flags through the model. Returns
    new_result()'s fields over all scenes (maps [2, H, W] per output frame,
    refined and fused, only with keep_maps)."""
    dev = resolve_device(args.device)
    set_fp32_numerics()
    if not (args.synthetic or args.datapath):
        raise SystemExit("need --datapath or --synthetic")
    model = build_model(args)
    # --fetch-half: the two scored maps cross to the host as bfloat16
    fetch = torch.bfloat16 if args.fetch_half else None
    if args.scan:
        proc = SequenceProcessor(model, args.lwindow, args.memory_size,
                                 chunk=args.chunk,
                                 output_scales=SCORED_SCALES,
                                 output_dtype=fetch, device=dev)
    else:
        runner = ESTMRunner(model, args.height, args.width, args.lwindow,
                            args.memory_size,
                            return_probs=args.reference_layout,
                            output_scales=SCORED_SCALES, output_dtype=fetch,
                            device=dev)
    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
    total = new_result()
    group = []  # --scan: scenes queued for one process_scenes call

    def flush():
        add_result(total, run_scenes_scan(proc, group, args, args.outdir,
                                          keep_maps))
        group.clear()

    for name, frames in scenes(args):
        if not args.scan:
            res = run_scene(runner, frames, args, args.outdir, name,
                            keep_maps)
            add_result(total, res)
            print(f"{name}: {len(res['times'])} frames")
            continue
        t0 = time.perf_counter()
        frames = read_scan_scene(frames, args, total["host"])
        total["seconds"] += time.perf_counter() - t0
        if frames is None:
            print(f"{name}: 0 windows (fewer frames than the window)")
            continue
        group.append((name, frames))
        if len(group) == args.scene_batch:
            flush()
    if group:  # the partial last group, at its own size
        flush()
    return total


def stream_scene(runner: ESTMRunner, frames: list, lwindow: int):
    """Stream one scene frame by frame, each frame's maps fetched before the
    next frame is pushed: per-output seconds (push + fetch, the latency of
    one frame), the fetched maps [2, H, W], and their scores against the
    window's centre frame (eval_hybrid_seq.py:202), taken outside the
    timed region."""
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
                  fused_attention: bool = False,
                  compute_dtype: str = "float32") -> dict:
    """ESTM streaming over synthetic scenes (seeds 0..scenes-1) with random
    weights from `seed`, frame by frame (stream_scene): the per-frame
    latency the main path is measured by.

    Returns {"times": seconds per output frame, "maps": per-frame
    [2, H, W] (refined, fused) depth, "errors": per-frame metrics}."""
    dev = resolve_device(device)
    set_fp32_numerics()
    model = DepthNetHybrid(ModelConfig(
        ndepths=ndepths, depth_min=depth_min, depth_max=depth_max,
        resnet=resnet, frustum_mode=frustum_mode,
        use_fused_attention=fused_attention, compute_dtype=compute_dtype),
        seed=seed)
    runner = ESTMRunner(model, height, width, lwindow, memory_size,
                        output_scales=SCORED_SCALES, device=dev)
    times, maps, errs = [], [], []
    for scene_seed in range(scenes):
        cfg = SyntheticSceneConfig(height=height, width=width,
                                   seed=scene_seed)
        frames = list(synthetic_stream(cfg, n_frames, depth_min, depth_max))
        t, m, e = stream_scene(runner, frames, lwindow)
        times += t
        maps += m
        errs += e
    return {"times": times, "maps": maps, "errors": errs}


def parse_args(argv=None):
    ev, mc = EvalConfig(), ModelConfig()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--datapath", type=str, default=None)
    p.add_argument("--testlist", type=str, default=None)
    p.add_argument("--eval-dataset", choices=["scannet", "7scenes"],
                   default="scannet")
    p.add_argument("--synthetic", action="store_true",
                   help="stream synthetic scenes instead of a dataset")
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
    p.add_argument("--lwindow", type=int, default=ev.lwindow)
    p.add_argument("--memory-size", type=int, default=ev.memory_size)
    p.add_argument("--frame-interval", type=int, default=10)
    p.add_argument("--start-index", type=int, default=0,
                   help="offset of the first subsampled frame (reference "
                        "start_i, general_eval_seq.py:48-49)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--save-maps", action="store_true")
    p.add_argument("--reference-layout", action="store_true",
                   help="write the reference's output tree with the "
                        "probability maps (streaming only)")
    p.add_argument("--scan", action="store_true",
                   help="each scene through the chunked SequenceProcessor "
                        "(the same maps as streaming)")
    p.add_argument("--chunk", type=int, default=16,
                   help="frames per chunk with --scan")
    p.add_argument("--scene-batch", type=int, default=1,
                   help="with --scan: evaluate this many independent scenes "
                        "per batched SequenceProcessor call (the same maps "
                        "as --scene-batch 1). Scenes are grouped as they "
                        "are read; the partial last group runs at its own "
                        "size (the JAX tool pads it to avoid a recompile, "
                        "which PyTorch does not have)")
    p.add_argument("--fetch-half", action="store_true",
                   help="fetch the two scored maps in bfloat16 instead of "
                        "float32: half the device-to-host copy (the saved "
                        "maps are float16 either way)")
    p.add_argument("--scenes", type=int, default=2,
                   help="synthetic scenes with --synthetic")
    p.add_argument("--frames", type=int, default=12,
                   help="frames per synthetic scene with --synthetic")
    add_model_flags(p)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights without --ckpt")
    p.add_argument("--device", type=str, default=None)
    return p.parse_args(argv)


def print_summary(times: list, errors: list) -> None:
    """The JAX tool's closing lines: steady-state time per frame (the
    first four skipped) and the mean metrics."""
    if times:
        steady = np.mean(times[4:] or times)
        print(f"inference time: {steady:.4f}s ({1.0 / steady:.2f} fps)")
    if errors:
        means = {k: float(np.mean([e[k] for e in errors]))
                 for k in METRIC_KEYS}
        print("metrics:", " ".join(f"{k}={v:.4f}" for k, v in means.items()))


def main(argv=None) -> None:
    args = parse_args(argv)
    print("args:", vars(args))
    res = run(args)
    print_summary(res["times"], res["errors"])


if __name__ == "__main__":
    main()
