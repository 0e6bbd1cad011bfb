"""Whole-scan requests of a feed-forward multi-view network, VGGT's: the
scans of mvs_views (protocols/mvs_views.py), one client in a closed loop
through the port's `eval/mvs.py:MVSRunner.run_view`, each request one
whole scan, its depth maps, confidences and cameras fetched to the host
before the next request is sent.

Traffic (`traffic/<mix>.json`): `scenes` synthetic scans from the seed,
each of `scene.frames` views along the mix's camera path
(harness/scenes.py) at the configuration's size. A request is one scan,
all its views in order, view 0 first (the network takes no cameras; they
are sent and not read); the scans are sent in turn, then again from the
first. It delivers one depth map a view: `joint_targets_per_s` counts
`scene.frames` targets a request. Set-up warms the runner on
`warmup_requests` requests of a scan of its own.

Output check: `check_requests` delivered requests, the first (the first
scan instance) and `check_requests` - 1 drawn from the seed among the
other delivered requests (a reservoir sample kept as the window runs),
are computed again by the reference after `release()`, in float32 and
then cast wholly to bfloat16 (weights, activations, the residual stream
and the heads: the precision below the configuration's bf16 autocast).
Numbers compared, over every pixel of every view of the checked
requests: `log_depth_gap`, the largest |x_port - x_ref| of the depth
logits (depth = exp(x)), and `log_depth_gap_median`, their median;
`log_confidence_gap`, the largest gap of the confidence logits
(confidence = 1 + exp(c)); `pose_gap`, the largest |port - reference| of
the 9-number pose encodings; and `bf16_gap_ratio`, the mean over the
depth logits, the confidence logits and the pose encodings of the
program's largest gap over the bf16 reference's largest gap from the
float32 reference on the same scans. How far bf16 rounding moves the
random network's outputs changes from seed to seed by up to 2.5x, as
much as the program and the bf16 reference differ, so no absolute gap
separates them with room; the ratio does (portbench/limits/ and PERF.md
give the readings).

`control_numbers` gives the same numbers for the control, the bf16
reference in the program's place, on the seed's scans: the first and
`check_requests` - 1 drawn from the seed among the others. Its
`bf16_gap_ratio` is 1 by construction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.harness import models
from portbench.harness.scenes import Path, make_scenes
from portbench.protocols import mvs_views

CHECKED = ("depth_logit", "confidence_logit", "pose_enc")


@dataclasses.dataclass(frozen=True)
class Request:
    instance: int
    kind: str = "scan"


class Scans:
    """The mix's scans from the seed and the inputs of each request."""

    def __init__(self, cell, seed: int, device):
        cfg, mix = cell.config, cell.mix
        self.path = Path(height=cfg["height"], width=cfg["width"],
                         **mix["scene"])
        scenes = make_scenes(self.path, mix["scenes"] + 1,
                             np.random.SeedSequence([seed, 1]), device)
        self.warm, self.scenes = scenes[0], scenes[1:]

    @staticmethod
    def of(scene):
        """(imgs [1, S, H, W, 3] uint8, poses [1, S, 4, 4], intr
        [1, 3, 3]) of the scan `scene`."""
        return scene.frames[None], scene.poses[None], scene.intr[None]

    def request(self, req: Request):
        return self.of(self.scenes[req.instance % len(self.scenes)])


class Session(mvs_views.Session):
    def __init__(self, cell, seed: int, device):
        from estdepth_tpu_torch.eval.mvs import MVSRunner

        self.cell, self.seed = cell, seed
        cfg = cell.config
        self.model = models.port(cfg, models.weights(cfg, seed, device),
                                 device)
        self.scans = Scans(cell, seed, device)
        self.runner = MVSRunner(self.model, return_all=True, device=device)
        for _ in range(cell.mix["warmup_requests"]):
            self.runner.run_view(*self.scans.of(self.scans.warm))[
                "depth"].cpu()
        self.rng = np.random.default_rng([seed, 2])
        self.kept: dict[int, tuple] = {}  # slot -> (request, outputs)
        self.delivered = 0
        self.bad = 0
        self._next = 0

    def next_request(self) -> Request:
        self._next += 1
        return Request(self._next - 1)

    def issue(self, req: Request):
        return self.runner.run_view(*self.scans.request(req))

    def _slot(self) -> int | None:
        """The slot of the request delivered now, or None: slot 0 is the
        first request's, the others a reservoir sample of the rest."""
        n = self.delivered
        self.delivered += 1
        k = self.cell.mix["check_requests"] - 1
        if n == 0:
            return 0
        if n <= k:
            return n
        j = int(self.rng.integers(n))
        return j + 1 if j < k else None

    def fetch(self, req: Request, pending) -> int:
        maps = [pending[k][0].cpu()
                for k in ("depth", "confidence", "pose_enc")]
        self.bad += not all(bool(torch.isfinite(m).all()) for m in maps)
        slot = self._slot()
        if slot is not None:  # what the check compares: the logits
            self.kept[slot] = (req, {k: pending[k][0].float().cpu()
                                     for k in CHECKED})
        return maps[0].shape[0]

    def failed(self) -> int:
        """Delivered requests whose depth, confidence or pose encoding
        holds a value that is not finite."""
        return self.bad

    def span_modules(self) -> dict:
        """The aggregator (DINOv2 and the alternating blocks) and the two
        heads."""
        m = self.model
        return {"aggregator": m.aggregator, "camera_head": m.camera_head,
                "depth_head": m.depth_head}

    def check(self, reference) -> list:
        """The checked numbers; casts `reference` to bfloat16 on the
        way."""
        requests, got = zip(*(self.kept[s] for s in sorted(self.kept)))
        want = reference_maps(reference, self.scans, requests)
        low = reference_maps(reference.to(torch.bfloat16), self.scans,
                             requests)
        return compare(got, want, low, self.cell.limits)

    def flops(self, reference) -> dict:
        """The reference's operations on one scan (FlopCounterMode: its
        matmuls and convolutions), counted on the meta device."""
        from torch.utils.flop_counter import FlopCounterMode

        cfg = self.cell.config
        path = self.scans.path
        with torch.device("meta"):
            ref = models.family(cfg).structure(cfg)
            imgs = torch.empty((1, path.frames, path.height, path.width, 3),
                               dtype=torch.uint8)
            with FlopCounterMode(display=False) as fc:
                ref(imgs)
        return {"scan": fc.get_total_flops()}


@torch.inference_mode()
def reference_maps(reference, scans: Scans, requests) -> list:
    """The reference's logits and pose encodings of each request, float32
    on the host."""
    dev = next(reference.parameters()).device
    out = []
    for req in requests:
        o = reference(*(torch.as_tensor(a).to(dev)
                        for a in scans.request(req)))
        out.append({k: o[k][0].float().cpu() for k in CHECKED})
    return out


def gaps(got, want) -> dict:
    """The largest (and for the depth the median) |got - want| of outputs
    `got` against `want`, lists of {"depth_logit", "confidence_logit"
    [S, h, w], "pose_enc" [S, 9]}."""
    depth = torch.cat([(g["depth_logit"] - r["depth_logit"]).abs()
                       .reshape(-1) for g, r in zip(got, want)])
    conf = max(float((g["confidence_logit"] - r["confidence_logit"])
                     .abs().max()) for g, r in zip(got, want))
    pose = max(float((g["pose_enc"] - r["pose_enc"]).abs().max())
               for g, r in zip(got, want))
    return {"log_depth_gap": float(depth.max()),
            "log_depth_gap_median": float(depth.median()),
            "log_confidence_gap": conf, "pose_gap": pose}


RATIO_OF = ("log_depth_gap", "log_confidence_gap", "pose_gap")


def compare(got, want, low, limits) -> list:
    """The checked numbers of outputs `got` against the float32
    reference's `want`, `low` the bf16 reference's on the same scans."""
    numbers = gaps(got, want)
    base = gaps(low, want)
    numbers["bf16_gap_ratio"] = sum(
        numbers[k] / max(base[k], 1e-30) for k in RATIO_OF) / len(RATIO_OF)
    return [(k, v, limits[k]["limit"]) for k, v in numbers.items()]


def control_numbers(cell, seed: int, device) -> dict:
    """The control's numbers on the scans of `seed`: the reference cast
    wholly to bfloat16 against the float32 reference."""
    mix = cell.mix
    scans = Scans(cell, seed, device)
    rng = np.random.default_rng([seed, 2])
    drawn = rng.permutation(np.arange(1, mix["scenes"]))[
        :mix["check_requests"] - 1]
    requests = [Request(0)] + [Request(int(n)) for n in drawn]
    cfg = cell.config
    ref = models.reference(cfg, models.weights(cfg, seed, device), device)
    want = reference_maps(ref, scans, requests)
    control = reference_maps(ref.to(torch.bfloat16), scans, requests)
    limits = {k: {"limit": None} for k in cell.limits}
    return {k: v for k, v, _ in compare(control, want, control, limits)}
