"""Multi-view stereo requests of a recorded scan, one client in a closed
loop: the port's `eval/mvs.py:MVSRunner.run_view`, each request's final
depth and photometric confidence fetched to the host before the next
request is sent, as the published test script saves both for fusion.

Traffic (`traffic/<mix>.json`): `scenes` synthetic scenes from the seed,
each of `scene.frames` views along the mix's camera path
(harness/scenes.py) at the configuration's size. A request is one
reference view and the configuration's `views` - 1 source views whose
camera centres lie nearest to its own (ties to the lower index), in
place of the published pair.txt; every view of a scene is the reference
once, in order, then the next scene, and the scenes again from the first.
It delivers one depth map and its confidence, float32 [H, W] each. Set-up
warms the runner on `warmup_views` requests of a scene of its own.

Output check: `check_views` delivered requests, the first scene
instance's first view (instances run in order, so the first is the
longest) and `check_views` - 1 drawn from the seed among the other
delivered requests (a reservoir sample kept as the window runs, so the
window holds only the maps it checks), are computed again by the
reference after `release()`, each of its stages 2 and 3 started from the
port's previous-stage depth (reference/casmvsnet.py says why: the
sample's hard border mask). Numbers compared: `depth_gap_m`, the largest
|port - reference| of the three stages' depths, the final one the
delivered map; `confidence_gap`, the largest |port - reference| of the
confidence over the pixels where both truncate sum_i i p_i to the same
plane idx; `index_flip_share`, the share of pixels where they do not.

`control_numbers` gives the same numbers with the reference computed with
TF32 in the program's place, the precision below the configuration's, on
the seed's views, checked as the program is: the upper end of each limit
(portbench/calibrate.py runs the other protocols' controls).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.harness import models
from portbench.harness.scenes import Path, make_scenes


@dataclasses.dataclass(frozen=True)
class Request:
    instance: int
    view: int
    kind: str = "view"


def nearest_sources(poses: np.ndarray, count: int) -> list[list[int]]:
    """For each view, the `count` other views whose camera centres lie
    nearest to its own, nearest first, ties to the lower index."""
    centres = poses[:, :3, 3].astype(np.float64)
    dist = np.linalg.norm(centres[:, None] - centres[None], axis=-1)
    return [[int(j) for j in np.argsort(row, kind="stable") if j != i][
        :count] for i, row in enumerate(dist)]


class Views:
    """The mix's scenes from the seed and the views of each request."""

    def __init__(self, cell, seed: int, device):
        cfg, mix = cell.config, cell.mix
        self.path = Path(height=cfg["height"], width=cfg["width"],
                         **mix["scene"])
        scenes = make_scenes(self.path, mix["scenes"] + 1,
                             np.random.SeedSequence([seed, 1]), device)
        self.warm, self.scenes = scenes[0], scenes[1:]
        self.sources = nearest_sources(self.warm.poses, cfg["views"] - 1)

    def of(self, scene, view: int):
        """(imgs [1, V, H, W, 3] uint8, poses [1, V, 4, 4], intr
        [1, 3, 3]) of the request whose reference is `view`."""
        idx = [view, *self.sources[view]]
        return scene.frames[idx][None], scene.poses[idx][None], scene.intr[
            None]

    def request(self, req: Request):
        return self.of(self.scenes[req.instance % len(self.scenes)],
                       req.view)


class Session:
    def __init__(self, cell, seed: int, device):
        from estdepth_tpu_torch.eval.mvs import MVSRunner

        self.cell, self.seed = cell, seed
        cfg, mix = cell.config, cell.mix
        self.model = models.port(cfg, models.weights(cfg, seed, device),
                                 device)
        self.views = Views(cell, seed, device)
        self.runner = MVSRunner(self.model, return_all=True, device=device)
        for v in range(mix["warmup_views"]):
            self.runner.run_view(*self.views.of(self.views.warm, v))[
                "depth"].cpu()
        self.rng = np.random.default_rng([seed, 2])
        self.kept: dict[int, tuple] = {}  # slot -> (request, maps)
        self.delivered = 0
        self.bad = 0
        self._next = 0

    def next_request(self) -> Request:
        n = self._next
        self._next += 1
        frames = self.views.path.frames
        return Request(n // frames, n % frames)

    def issue(self, req: Request):
        return self.runner.run_view(*self.views.request(req))

    def _slot(self) -> int | None:
        """The slot of the request delivered now, or None: slot 0 is the
        first request's, the others a reservoir sample of the rest."""
        n = self.delivered
        self.delivered += 1
        k = self.cell.mix["check_views"] - 1
        if n == 0:
            return 0
        if n <= k:
            return n
        j = int(self.rng.integers(n))
        return j + 1 if j < k else None

    def fetch(self, req: Request, pending) -> int:
        depth = pending["depth"][0].cpu()
        confidence = pending["confidence"][0].cpu()
        self.bad += not bool(torch.isfinite(depth).all()
                             and torch.isfinite(confidence).all())
        slot = self._slot()
        if slot is not None:  # what the check needs besides the maps
            self.kept[slot] = (req, {
                "depth": depth, "confidence": confidence,
                "index": pending["index"][0].to(torch.uint8).cpu(),
                "stage_depths": [d[0].cpu()
                                 for d in pending["stage_depths"][:-1]]})
        return 1

    @staticmethod
    def end_to_end(recs, window_s: float) -> dict:
        return {"joint_targets_per_s":
                sum(r.delivered for r in recs) / window_s}

    def failed(self) -> int:
        """Delivered requests whose depth or confidence holds a value that
        is not finite."""
        return self.bad

    def span_modules(self) -> dict:
        """The feature net and each stage's 3D U-Net."""
        stages = self.model.cost_regularization
        return {"feature": self.model.feature,
                **{f"CostRegNet{k + 1}": m for k, m in enumerate(stages)}}

    def release(self) -> None:
        del self.runner, self.model
        torch.cuda.empty_cache()

    def check(self, reference) -> list:
        requests, got = zip(*(self.kept[s] for s in sorted(self.kept)))
        want = reference_maps(reference, self.views, requests, got)
        return compare(got, want, self.cell.limits)

    @torch.inference_mode()
    def flops(self, reference) -> dict:
        from torch.utils.flop_counter import FlopCounterMode

        dev = next(reference.parameters()).device
        with FlopCounterMode(display=False) as fc:
            reference(*(torch.as_tensor(a).to(dev)
                        for a in self.views.request(Request(0, 0))))
        return {"view": fc.get_total_flops()}


@torch.inference_mode()
def reference_maps(reference, views: Views, requests, starts=None) -> list:
    """The reference's maps of each request on the host, as `compare`
    takes them; `starts` gives each request's maps whose stage depths its
    stages 2 and 3 start from (None: its own)."""
    dev = next(reference.parameters()).device
    out = []
    for n, req in enumerate(requests):
        prev = None if starts is None else [
            d[None].to(dev) for d in starts[n]["stage_depths"]]
        o = reference(*(torch.as_tensor(a).to(dev)
                        for a in views.request(req)), prev_depths=prev)
        out.append({"depth": o["depth"][0].cpu(),
                    "confidence": o["confidence"][0].cpu(),
                    "index": o["index"][0].to(torch.uint8).cpu(),
                    "stage_depths": [d[0].cpu()
                                     for d in o["stage_depths"][:-1]]})
    return out


def compare(got, want, limits) -> list:
    """The checked numbers of maps `got` against `want`, lists of
    {"depth", "confidence", "index", "stage_depths" (stages 1 and 2)}."""
    depth_gap = conf_gap = 0.0
    flips = pixels = 0
    for g, r in zip(got, want):
        for d, rd in zip([*g["stage_depths"], g["depth"]],
                         [*r["stage_depths"], r["depth"]]):
            depth_gap = max(depth_gap, float((d - rd).abs().max()))
        same = g["index"] == r["index"]
        flips += int((~same).sum())
        pixels += same.numel()
        if same.any():
            conf_gap = max(conf_gap, float(
                (g["confidence"] - r["confidence"]).abs()[same].max()))
    numbers = {"depth_gap_m": depth_gap, "confidence_gap": conf_gap,
               "index_flip_share": flips / max(pixels, 1)}
    return [(k, v, limits[k]["limit"]) for k, v in numbers.items()]


def control_numbers(cell, seed: int, device) -> dict:
    """The control's numbers on the views of `seed`: the first scene's
    first view and `check_views` - 1 drawn from the seed among one pass
    over the scenes, by the reference with TF32 against the reference
    without."""
    cfg, mix = cell.config, cell.mix
    views = Views(cell, seed, device)
    frames = views.path.frames
    rng = np.random.default_rng([seed, 2])
    drawn = rng.permutation(np.arange(1, mix["scenes"] * frames))[
        :mix["check_views"] - 1]
    requests = [Request(0, 0)] + [Request(int(n) // frames, int(n) % frames)
                                  for n in drawn]
    ref = models.reference(cfg, models.weights(cfg, seed, device), device)
    models.set_numerics(True)
    control = reference_maps(ref, views, requests)
    models.set_numerics(False)
    want = reference_maps(ref, views, requests, control)
    models.set_numerics(cfg["tf32"])
    limits = {k: {"limit": None} for k in cell.limits}
    return {k: v for k, v, _ in compare(control, want, limits)}
