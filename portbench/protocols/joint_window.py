"""Joint windows, one client in a closed loop: the port's
`tools/eval_joint.py:JointRunner.run_window`, each window's target maps
fetched to the host before the next window is sent.

Traffic (`traffic/<mix>.json`): `scenes` synthetic scenes from the seed
(`scene`: frames per scene and camera path), each cut into windows of the
configuration's `seq_length` frames that advance by seq_length - 2 frames,
so that their targets tile the scene; the scenes run one after another and
again from the first, the runner (its 1-entry memory) reset at each
scene's start. A request is one window; it delivers its seq_length - 2
targets' maps at the scales of `fetch_scales`. Set-up warms the runner on
`warmup_windows` windows of a scene of its own.

Output check: the scene instance with the most windows in the window and
`check_scenes` - 1 more drawn from the seed, each run again by the
reference's Joint chain (reference/runners.py) from its first window to
the last one delivered; the number compared is the largest |port -
reference| over every map of them (`depth_gap_m`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.harness import models
from portbench.harness.scenes import Path, make_scenes
from portbench.protocols.estm_stream import span_modules
from portbench.reference.runners import joint_maps



@dataclasses.dataclass(frozen=True)
class Request:
    instance: int
    window: int
    kind: str  # "first" (no memory) or "steady"


class Session:
    def __init__(self, cell, seed: int, device):
        from estdepth_tpu_torch.tools.eval_joint import JointRunner

        self.cell, self.seed = cell, seed
        cfg, mix = cell.config, cell.mix
        self.length = cfg["seq_length"]
        self.stride = self.length - 2
        self.scales = list(mix["fetch_scales"])
        self.path = Path(height=cfg["height"], width=cfg["width"],
                         **mix["scene"])
        self.windows = (self.path.frames - self.length) // self.stride + 1
        scenes = make_scenes(self.path, mix["scenes"] + 1,
                             np.random.SeedSequence([seed, 1]), device)
        warm, self.scenes = scenes[0], scenes[1:]
        self.model = models.port(cfg, models.weights(cfg, seed, device),
                                 device)
        self.runner = JointRunner(self.model, device=device)
        for w in range(mix["warmup_windows"]):
            self.runner.run_window(*self._window(warm, w))[0].cpu()
        self.runner.reset()
        self.outputs: dict[int, list] = {}
        self._next = (0, 0)

    def _window(self, scene, w):
        lo = w * self.stride
        sl = slice(lo, lo + self.length)
        return scene.frames[sl][None], scene.poses[sl][None], scene.intr[None]

    def next_request(self) -> Request:
        inst, w = self._next
        self._next = (inst, w + 1) if w + 1 < self.windows else (inst + 1, 0)
        return Request(inst, w, "first" if w == 0 else "steady")

    def issue(self, req: Request):
        if req.window == 0:
            self.runner.reset()
        scene = self.scenes[req.instance % len(self.scenes)]
        return self.runner.run_window(*self._window(scene, req.window))[0]

    def fetch(self, req: Request, pending) -> int:
        maps = pending[0][:, self.scales].cpu().numpy()
        self.outputs.setdefault(req.instance, []).append(maps)
        return maps.shape[0]

    @staticmethod
    def end_to_end(recs, window_s: float) -> dict:
        return {"joint_targets_per_s":
                sum(r.delivered for r in recs) / window_s}

    def failed(self) -> int:
        """Delivered requests whose maps hold a value that is not
        finite."""
        return sum(not np.isfinite(m).all()
                   for maps in self.outputs.values() for m in maps)

    def span_modules(self) -> dict:
        return span_modules(self.model)

    def release(self) -> None:
        del self.runner, self.model
        torch.cuda.empty_cache()

    def _chosen(self) -> list[int]:
        counts = {i: len(m) for i, m in self.outputs.items()}
        longest = max(counts, key=lambda i: (counts[i], -i))
        rest = sorted(set(counts) - {longest})
        rng = np.random.default_rng([self.seed, 2])
        extra = rng.permutation(rest)[:self.cell.mix["check_scenes"] - 1]
        return [longest, *(int(i) for i in extra)]

    def check(self, reference) -> list:
        gap = 0.0
        for inst in self._chosen():
            scene = self.scenes[inst % len(self.scenes)]
            got = self.outputs[inst]
            windows = [(f[0], p[0]) for f, p, _ in
                       (self._window(scene, w) for w in range(len(got)))]
            ref = joint_maps(reference, windows, scene.intr, self.scales)
            for g, r in zip(got, ref):
                gap = max(gap, float(np.abs(g - r.cpu().numpy()).max()))
        return [("depth_gap_m", gap, self.cell.limits["depth_gap_m"]["limit"])]

    def flops(self, reference) -> dict:
        from torch.utils.flop_counter import FlopCounterMode

        scene = self.scenes[0]
        counts = []
        for n in (1, 2):
            windows = [(f[0], p[0]) for f, p, _ in
                       (self._window(scene, w) for w in range(n))]
            with FlopCounterMode(display=False) as fc:
                joint_maps(reference, windows, scene.intr, self.scales)
            counts.append(fc.get_total_flops())
        return {"first": counts[0], "steady": counts[1] - counts[0]}
