#!/usr/bin/env python3
"""Where `--scene-batch 4` departs from `--scene-batch 1` on the card.

    python scripts/scene_batch_cudnn.py [--out FILE]

Both eval tools run `--scan` at the flagship width (256x320, D = 64,
ResNet-50, random weights from seed 0) over five ScanNet-layout scenes of
7, 12, 8, 6 and 9 frames (chip_smoke.py's phase_scene_batch scenes) at
--scene-batch 1 and 4, in float32 and bf16, once with cuDNN and once
without it (torch.backends.cudnn.enabled = False: ATen's own
convolutions, which run one sample at a time, so a sample's arithmetic
does not depend on the batch). Prints one JSON line per dtype and cuDNN
setting, with the card's name and power limit: each tool's batch-4
against batch-1 max |Δ| (m), and the bf16 maps' distance from the
float32 maps of the same setting. If the batching
code is right, the batch-4 maps without cuDNN stay within rounding of the
batch-1 maps, and what cuDNN adds is its choice of another algorithm at
another batch.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from estdepth_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticSceneConfig, pose, write_scannet_scene,
)
from estdepth_tpu_torch.tools import eval_estm, eval_joint  # noqa: E402

SCENE_FRAMES = (7, 12, 8, 6, 9)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="also write the lines here")
    out = p.parse_args().out
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    lines = []
    with tempfile.TemporaryDirectory(prefix="scene_batch_cudnn_") as root:
        for seed, n in enumerate(SCENE_FRAMES):
            cfg = SyntheticSceneConfig(height=240, width=320, focal=288.935,
                                       seed=seed)
            write_scannet_scene(os.path.join(root, f"scene{seed:04d}_00"),
                                cfg, [pose(cfg, i) for i in range(n)])
        common = ["--datapath", root, "--frame-interval", "1", "--height",
                  "256", "--width", "320", "--ndepths", "64", "--resnet",
                  "50", "--scan", "--device", "cuda", "--seed", "0"]
        f32 = {}
        for cudnn in (True, False):
            torch.backends.cudnn.enabled = cudnn
            for dtype in ("float32", "bfloat16"):
                line = {"cudnn": cudnn, "dtype": dtype, "card": card}
                for name, tool in (("estm", eval_estm), ("joint", eval_joint)):
                    maps = {b: np.stack(tool.run(tool.parse_args(
                        common + ["--scene-batch", str(b)]
                        + (["--bf16"] if dtype == "bfloat16" else [])),
                        keep_maps=True)["maps"]) for b in (1, 4)}
                    line[f"{name}_batch4_vs_batch1"] = float(
                        np.abs(maps[4] - maps[1]).max())
                    if dtype == "float32":
                        f32[cudnn, name] = maps[1]
                    else:
                        line[f"{name}_bf16_vs_f32"] = float(
                            np.abs(maps[1] - f32[cudnn, name]).max())
                print(json.dumps(line), flush=True)
                lines.append(line)
    torch.backends.cudnn.enabled = True
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
