"""Rehearse the day a released checkpoint arrives: ckpt -> convert ->
eval -> score (counterpart of tools/rehearse_release_ckpt.py).

    python -m estdepth_tpu_torch.tools.rehearse_release_ckpt
        [--ckpt released.ckpt] [--datapath DIR [--testlist F]]

The reference ships its trained model as a torch .ckpt in the layout of
its train_hybrid.py:137-142: `{"epoch", "model", "optimizer"}`. That file
is not at hand, so the rehearsal runs the whole flow with a stand-in:

  1. GENERATE (unless --ckpt): the port's own model with random weights
     from --seed, saved in that layout (its state_dict under the DDP
     `module.` prefix, and the state of a torch Adam optimizer of the
     reference's recipe);
  2. CONVERT: utils/convert.load_reference_checkpoint; every name must
     place (`num_batches_tracked` and the encoder's `fc.` are dropped by
     rule) and every tensor of the model must be found;
  3. EVALUATE: tools/eval_estm.py `--ckpt <ckpt> --save-maps` through its
     own argument parser and `run`;
  4. SCORE: tools/score_offline.py over the saved maps.

With the real file the same flow is

    python -m estdepth_tpu_torch.tools.rehearse_release_ckpt \
        --ckpt released.ckpt --datapath /data/scannet_test --testlist F

Data: --datapath (ScanNet or 7-Scenes layout), else synthetic scenes.
Prints one JSON summary, then RELEASE REHEARSAL: PASS or FAIL (exit 1).
Not here, of the JAX tool's flags: --parity-gate runs the reference's own
code, which is not in this repository.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from estdepth_tpu_torch.config import ModelConfig
from estdepth_tpu_torch.models.estdepth import DepthNetHybrid
from estdepth_tpu_torch.tools import eval_estm, score_offline
from estdepth_tpu_torch.tools.eval_estm import METRIC_KEYS
from estdepth_tpu_torch.utils.convert import load_reference_checkpoint


def generate_reference_ckpt(path: str, ndepths: int = 64,
                            depth_min: float = 0.01, depth_max: float = 10.0,
                            resnet: int = 50, epoch: int = 6,
                            seed: int = 0) -> str:
    """Write a reference-layout .ckpt of the port's model with random
    weights from `seed`: {"epoch", "model" (names under `module.`, as the
    reference saves its DDP-wrapped model), "optimizer" (a torch Adam of
    the reference's recipe, train_hybrid.py:80-82)}."""
    model = DepthNetHybrid(ModelConfig(ndepths=ndepths, depth_min=depth_min,
                                       depth_max=depth_max, resnet=resnet),
                           seed=seed)
    optimizer = torch.optim.Adam(model.parameters(), lr=4e-5,
                                 betas=(0.9, 0.999), weight_decay=4e-4)
    torch.save({"epoch": epoch,
                "model": {f"module.{k}": v
                          for k, v in model.state_dict().items()},
                "optimizer": optimizer.state_dict()}, path)
    return path


def convert_coverage(ckpt: str, args) -> dict:
    """Step 2: the names the converter could not place and the model's
    tensors the checkpoint lacks."""
    state, unmatched = load_reference_checkpoint(ckpt, strict=False)
    model = DepthNetHybrid(ModelConfig(
        ndepths=args.ndepths, depth_min=args.depth_min,
        depth_max=args.depth_max, resnet=args.resnet))
    wanted = {k for k in model.state_dict()
              if not k.endswith("num_batches_tracked")}
    return {"tensors": len(state), "torch_keys_unmatched": len(unmatched),
            "unmatched_sample": unmatched[:8],
            "model_tensors_missing": sorted(wanted - set(state))[:8]}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", type=str, default=None,
                   help="an existing reference .ckpt (e.g. the release); "
                        "omitted: generate a stand-in")
    p.add_argument("--outdir", type=str, default="./output/release_rehearsal")
    p.add_argument("--ndepths", type=int, default=64)
    p.add_argument("--resnet", type=int, default=50)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--depth-min", type=float, default=0.01)
    p.add_argument("--depth-max", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the stand-in's weights")
    p.add_argument("--datapath", type=str, default=None,
                   help="eval data root; omitted: synthetic scenes")
    p.add_argument("--testlist", type=str, default=None)
    p.add_argument("--eval-dataset", choices=["scannet", "7scenes"],
                   default="scannet")
    p.add_argument("--frame-interval", type=int, default=10)
    p.add_argument("--max-frames", type=int, default=12,
                   help="output frames per scene")
    p.add_argument("--device", type=str, default=None,
                   help="device of the eval step (default: the CUDA device)")
    return p.parse_args(argv)


def _data_flags(args) -> list[str]:
    if not args.datapath:
        return ["--synthetic"]
    flags = ["--datapath", args.datapath, "--eval-dataset",
             args.eval_dataset]
    return flags + (["--testlist", args.testlist] if args.testlist else [])


def main(argv=None) -> dict:
    """The rehearsal; returns the summary (exits 1 on FAIL)."""
    args = parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    summary = {}

    # 1. the checkpoint
    ckpt = args.ckpt
    if ckpt is None:
        ckpt = generate_reference_ckpt(
            os.path.join(args.outdir, "model_000006.ckpt"),
            ndepths=args.ndepths, depth_min=args.depth_min,
            depth_max=args.depth_max, resnet=args.resnet, seed=args.seed)
        print(f"[1/4] generated a reference-layout checkpoint: {ckpt}")
    summary["ckpt"] = {"path": ckpt, "generated": args.ckpt is None}

    # 2. conversion coverage
    summary["convert"] = convert_coverage(ckpt, args)
    print(f"[2/4] converted: {summary['convert']}")

    # 3. the eval tool, maps saved
    preddir = os.path.join(args.outdir, "maps")
    shape = ["--height", str(args.height), "--width", str(args.width)]
    eval_argv = ["--ckpt", ckpt, "--outdir", preddir, "--save-maps",
                 "--ndepths", str(args.ndepths), "--resnet",
                 str(args.resnet), "--depth-min", str(args.depth_min),
                 "--depth-max", str(args.depth_max), "--frame-interval",
                 str(args.frame_interval), "--max-frames",
                 str(args.max_frames), *shape, *_data_flags(args)]
    if args.device:
        eval_argv += ["--device", args.device]
    print(f"[3/4] eval_estm {' '.join(eval_argv)}")
    res = eval_estm.run(eval_estm.parse_args(eval_argv))
    summary["eval"] = {"frames": len(res["times"]), "metrics": {
        k: float(np.mean([e[k] for e in res["errors"]]))
        for k in METRIC_KEYS} if res["errors"] else None}

    # 4. offline scoring of the saved maps
    scores_json = os.path.join(args.outdir, "scores.json")
    score_argv = ["--preddir", preddir, "--json", scores_json,
                  "--frame-interval", str(args.frame_interval), *shape,
                  *_data_flags(args)]
    print(f"[4/4] score_offline {' '.join(score_argv)}")
    summary["score"] = score_offline.main(score_argv)["overall"]

    print(json.dumps(summary, indent=2, default=str))
    ok = not (summary["convert"]["torch_keys_unmatched"]
              or summary["convert"]["model_tensors_missing"]
              or not summary["eval"]["frames"])
    print(f"RELEASE REHEARSAL: {'PASS' if ok else 'FAIL'}")
    if not ok:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
