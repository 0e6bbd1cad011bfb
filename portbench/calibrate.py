#!/usr/bin/env python3
"""The readings that a cell's output limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3
        --seconds <s> [--control-seeds 1,2,3]

In one process: for each of --seeds, one run of the cell as run.py makes
it (--trace 0, --seconds long), whose checked numbers are the program's
readings (the lower end of a limit); then, for each of --control-seeds,
the control: the reference computed with TF32 (the precision below the
configuration's float32 with TF32 off) put in the program's place on the
seed's inputs at the cell's size, checked against the float32 reference
as the program is (the upper end). The benchmark's own runs never run
this. Prints one JSON line per reading, then the largest program reading
and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cell, seed: int, device) -> dict:
    """The control's numbers on the inputs of `seed`."""
    import numpy as np
    import torch

    from portbench.harness import models
    from portbench.harness.scenes import Path as ScenePath, make_scenes
    from portbench.protocols.train_step import Session as Train, leaf_gap
    from portbench.reference import runners

    cfg, mix = cell.config, cell.mix

    def model(tf32: bool):
        models.set_numerics(tf32)
        return models.reference(cfg, models.weights(cfg, seed, device),
                                device)

    proto = mix["protocol"]
    if proto == "train_step":
        batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
                   for b in Train._windows(cfg, mix, seed, device)[:3]]
        tr = cfg["train"]
        out = {}
        for tf32 in (False, True):
            m = model(tf32)
            before = {k: p.detach().clone() for k, p in m.named_parameters()}
            losses, first = runners.train_steps(
                m, batches, tr["lr"], tr["weight_decay"], tr["clip"],
                tr["loss_weight"])
            grads = {k: float(g.norm()) for k, g in first.items()}
            out[tf32] = (losses, grads,
                         {k: float((p.detach() - before[k]).norm())
                          for k, p in m.named_parameters()})
            del m, before
        (l0, g0, c0), (l1, g1, c1) = out[False], out[True]
        med = float(np.median(list(g0.values())))
        moved = {k for k, g in g0.items() if g >= 1e-3 * med}
        models.set_numerics(cfg["tf32"])
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(l1, l0)),
                "grad_gap": leaf_gap(g1, g0),
                "change_gap": leaf_gap(c1, c0, moved)}
    path = ScenePath(height=cfg["height"], width=cfg["width"], **mix["scene"])
    scenes = make_scenes(path, mix["scenes"] + 1,
                         np.random.SeedSequence([seed, 1]), device)[1:]
    scales = list(mix["fetch_scales"])
    maps = {}
    for tf32 in (False, True):
        m = model(tf32)
        maps[tf32] = []
        for s in scenes[:mix["check_scenes"]]:
            if proto == "estm_stream":
                maps[tf32] += runners.stream_maps(
                    m, s.frames, s.poses, s.intr, scales, cfg["lwindow"],
                    cfg["memory_size"])
            else:
                v, stride = cfg["seq_length"], cfg["seq_length"] - 2
                wins = [(s.frames[lo:lo + v], s.poses[lo:lo + v])
                        for lo in range(0, path.frames - v + 1, stride)]
                maps[tf32] += runners.joint_maps(m, wins, s.intr, scales)
        del m
    models.set_numerics(cfg["tf32"])
    return {"depth_gap_m": max(float((a - b).abs().max())
                               for a, b in zip(maps[True], maps[False]))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import run as bench
    from portbench.harness import cell as cells

    bench._caches()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    lower, upper = {}, {}
    for seed in seeds:
        res = bench.run(argparse.Namespace(
            workload=args.workload, seed=seed, seconds=args.seconds,
            trace=0))
        nums = {k: v["value"] for k, v in res["checked"].items()}
        for k, v in nums.items():
            lower[k] = max(lower.get(k, 0.0), v)
        print(json.dumps({"program": seed, "correct": res["correct"],
                          "checked": nums, "metrics": res["metrics"]}),
              flush=True)
    cell = cells.load(ROOT, args.workload)
    for seed in control:
        nums = control_numbers(cell, seed, torch.device("cuda", 0))
        for k, v in nums.items():
            upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps({"control": seed, "checked": nums}), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
