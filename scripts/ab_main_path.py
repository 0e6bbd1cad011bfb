#!/usr/bin/env python3
"""Time the port's main paths in two checkouts on one card, in turns.

    python scripts/ab_main_path.py --parent build/parent [--rounds 2]
        [--frames 12] [--windows 6] [--path estm] [--path joint-mix]
        [--dtype float32] [--dtype bfloat16]

Each run is a fresh process in one tree that drives each chosen path in
each chosen compute dtype at the flagship width (256x320, D = 64,
ResNet-50, random weights from seed 0) on the CUDA device:
- `estm` streams one synthetic scene through
  tools/eval_estm.run_synthetic (lwindow 3, memory 2) and reports the
  median ms per frame of the outputs after the first two (push + fetch of
  the two scored maps);
- `joint-mix` runs the Joint chain of tools/eval_joint.run_synthetic with
  `--no-exact-z --fused-attention` (the plane-mix warp, whose K/V output
  the attention kernel reads next) and reports the median ms per window
  after the first.
The default is `estm` in float32. A round runs the parent, the change, the
change and the parent; the summary gives, for each path and dtype, each
tree's median over its runs and the change's ratio to the parent. The parent is
an unpacked `git archive` of another commit (in an ignored directory such
as build/); kernel libraries already built in this tree are copied to it
when their names (hashes of the sources) match, so that neither tree
rebuilds what the other has. Prints one JSON line per run and one for
the summary.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = """
import json, statistics
import torch
from estdepth_tpu_torch.tools import eval_estm, eval_joint
res = {{}}
for path in {paths!r}:
    for dtype in {dtypes!r}:
        if path == "estm":
            times = eval_estm.run_synthetic(
                scenes=1, n_frames={frames}, seed=0, device="cuda",
                compute_dtype=dtype)["times"][2:]
        else:
            times = eval_joint.run_synthetic(
                windows={windows}, frustum_mode="plane_mix",
                fused_attention=True, seed=0, device="cuda",
                compute_dtype=dtype)["times"][1:]
        torch.cuda.synchronize()
        res[path + " " + dtype] = statistics.median(1e3 * t for t in times)
print(json.dumps(res))
"""


def run(tree: Path, args) -> dict:
    code = RUN.format(paths=args.path, dtypes=args.dtype, frames=args.frames,
                      windows=args.windows)
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, check=True,
                         timeout=900)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--parent", required=True,
                   help="root of the other checkout")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--windows", type=int, default=6)
    p.add_argument("--path", action="append",
                   choices=["estm", "joint-mix"])
    p.add_argument("--dtype", action="append",
                   choices=["float32", "bfloat16"])
    args = p.parse_args(argv)
    args.path = args.path or ["estm"]
    args.dtype = args.dtype or ["float32"]
    parent = Path(args.parent).resolve()
    built = parent / "build" / "kernels"
    built.mkdir(parents=True, exist_ok=True)
    for lib in (ROOT / "build" / "kernels").glob("*.so"):
        if not (built / lib.name).exists():
            shutil.copy2(lib, built / lib.name)
    trees = {"parent": parent, "change": ROOT}
    ms = {}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            res = run(trees[name], args)
            for key, v in res.items():
                ms.setdefault(key, {n: [] for n in trees})[name].append(v)
            print(json.dumps({"tree": name, "ms": res}), flush=True)
    summary = {}
    for key, runs in ms.items():
        med = {name: statistics.median(v) for name, v in runs.items()}
        summary[key] = {**med, "runs_ms": runs,
                        "ratio_change_to_parent": med["change"]
                        / med["parent"]}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
