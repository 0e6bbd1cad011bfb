#!/usr/bin/env python3
"""Time the port's ESTM main path in two checkouts on one card, in turns.

    python scripts/ab_main_path.py --parent build/parent [--rounds 2]
        [--frames 12]

Each run is a fresh process in one tree that streams one synthetic scene
through tools/eval_estm.run_synthetic at the flagship width (256x320,
D = 64, ResNet-50, lwindow 3, memory 2, random weights from seed 0) on the
CUDA device and reports the median ms per frame of the outputs after the
first two (push + fetch of the two scored maps). A round runs the parent,
the change, the change and the parent; the summary gives each tree's
median over its runs and the change's ratio to the parent. The parent is
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
from estdepth_tpu_torch.tools.eval_estm import run_synthetic
res = run_synthetic(scenes=1, n_frames={frames}, seed=0, device="cuda")
torch.cuda.synchronize()
times = [1e3 * t for t in res["times"]]
print(json.dumps({{"ms_per_frame": statistics.median(times[2:]),
                  "times_ms": times}}))
"""


def run(tree: Path, frames: int) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN.format(frames=frames)],
                         cwd=tree, capture_output=True, text=True,
                         check=True, timeout=900)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--parent", required=True,
                   help="root of the other checkout")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--frames", type=int, default=12)
    args = p.parse_args(argv)
    parent = Path(args.parent).resolve()
    built = parent / "build" / "kernels"
    built.mkdir(parents=True, exist_ok=True)
    for lib in (ROOT / "build" / "kernels").glob("*.so"):
        if not (built / lib.name).exists():
            shutil.copy2(lib, built / lib.name)
    trees = {"parent": parent, "change": ROOT}
    ms = {name: [] for name in trees}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            res = run(trees[name], args.frames)
            ms[name].append(res["ms_per_frame"])
            print(json.dumps({"tree": name, **res}), flush=True)
    summary = {name: statistics.median(v) for name, v in ms.items()}
    summary["runs_ms"] = ms
    summary["ratio_change_to_parent"] = summary["change"] / summary["parent"]
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
