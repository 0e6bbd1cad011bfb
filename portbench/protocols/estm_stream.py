"""ESTM streaming, one stream in a closed loop: the port's
`eval/estm.py:ESTMRunner.push_frame`, each frame's maps fetched to the host
before the next frame is pushed (as `tools/eval_estm.py:stream_scene`).

Traffic (`traffic/<mix>.json`): `scenes` synthetic scenes from the seed
(`scene`: frames per scene and camera path), streamed one after another
and again from the first, the runner reset at each scene's start; the
fetched maps are the scales of `fetch_scales`. A request is one frame's
push and fetch; it delivers the window centre's maps once the window is
full. Set-up warms the runner on a scene of its own: the first window and
`warmup_frames` steady ones.

Output check: the scene instance with the most delivered frames and
`check_scenes` - 1 more drawn from the seed, each run again by the
reference stream (reference/runners.py) from its first frame to the last
one the window delivered; the number compared is the largest |port -
reference| over every map of them (`depth_gap_m`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.harness import models
from portbench.harness.scenes import Path, make_scenes
from portbench.reference.runners import stream_maps



@dataclasses.dataclass(frozen=True)
class Request:
    instance: int  # the scene instance: scenes[instance % len(scenes)]
    frame: int
    kind: str  # "fill" (no maps yet), "first" (no EST), "steady"


class Session:
    def __init__(self, cell, seed: int, device):
        from estdepth_tpu_torch.eval.estm import ESTMRunner

        self.cell, self.seed = cell, seed
        cfg, mix = cell.config, cell.mix
        self.lwindow = cfg["lwindow"]
        self.scales = tuple(mix["fetch_scales"])
        self.path = Path(height=cfg["height"], width=cfg["width"],
                         **mix["scene"])
        scenes = make_scenes(self.path, mix["scenes"] + 1,
                             np.random.SeedSequence([seed, 1]), device)
        warm, self.scenes = scenes[0], scenes[1:]
        self.model = models.port(cfg, models.weights(cfg, seed, device),
                                 device)
        self.runner = ESTMRunner(self.model, cfg["height"], cfg["width"],
                                 self.lwindow, cfg["memory_size"],
                                 output_scales=self.scales, device=device)
        for i in range(self.lwindow + mix["warmup_frames"]):
            out = self.runner.push_frame(warm.frames[i], warm.poses[i],
                                         warm.intr)
            if out is not None:
                out.cpu()
        self.outputs: dict[int, list] = {}
        self._next = (0, 0)

    def next_request(self) -> Request:
        inst, frame = self._next
        n = self.path.frames
        self._next = (inst, frame + 1) if frame + 1 < n else (inst + 1, 0)
        lw = self.lwindow
        kind = ("fill" if frame < lw - 1 else "first" if frame == lw - 1
                else "steady")
        return Request(inst, frame, kind)

    def issue(self, req: Request):
        scene = self.scenes[req.instance % len(self.scenes)]
        if req.frame == 0:
            self.runner.reset()
        return self.runner.push_frame(scene.frames[req.frame],
                                      scene.poses[req.frame], scene.intr)

    def fetch(self, req: Request, pending) -> int:
        if pending is None:
            return 0
        maps = pending[0].float().cpu().numpy()
        self.outputs.setdefault(req.instance, []).append(maps)
        return 1

    @staticmethod
    def end_to_end(recs, window_s: float) -> dict:
        done = [r for r in recs if r.delivered]
        lat = [1e3 * (r.t2 - r.t0) for r in done]
        return {"stream_frame_ms": 1e3 * window_s / len(done),
                "stream_frame_ms_p95": float(np.percentile(lat, 95))}

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
            last = self.lwindow - 1 + len(got)
            ref = stream_maps(reference, scene.frames[:last],
                              scene.poses[:last], scene.intr, self.scales,
                              self.lwindow, self.cell.config["memory_size"])
            if len(ref) != len(got):
                return [("depth_gap_m", float("inf"),
                         self.cell.limits["depth_gap_m"]["limit"])]
            for g, r in zip(got, ref):
                gap = max(gap, float(np.abs(g - r.cpu().numpy()).max()))
        return [("depth_gap_m", gap, self.cell.limits["depth_gap_m"]["limit"])]

    def flops(self, reference) -> dict:
        from torch.utils.flop_counter import FlopCounterMode

        scene = self.scenes[0]
        counts = []
        for n in (self.lwindow, self.lwindow + 1):
            with FlopCounterMode(display=False) as fc:
                stream_maps(reference, scene.frames[:n], scene.poses[:n],
                            scene.intr, self.scales, self.lwindow,
                            self.cell.config["memory_size"])
            counts.append(fc.get_total_flops())
        return {"fill": 0, "first": counts[0],
                "steady": counts[1] - counts[0]}


def span_modules(model) -> dict:
    """The submodules of the port's model that the traced half wraps in
    spans: both encoders, the decoder and the EST transformer."""
    return {"matchingFeature": model.matchingFeature,
            "semanticFeature": model.semanticFeature,
            "CostRegNet": model.CostRegNet,
            "epipolar_transformer": model.CostRegNet.epipolar_transformer}
