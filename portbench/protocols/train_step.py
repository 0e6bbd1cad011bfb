"""The training step, one process on one device: the port's
`train/trainer.py:make_train_step` over `train/trainer.make_optimizer`'s
Adam with the `train/schedule.py` warm-up, fed by the port's
`data/pipeline.prefetch_to_device` (each batch uploaded one step ahead),
the loss fetched to the host after every step.

Traffic (`traffic/<mix>.json`): `windows` training windows of the
configuration's `seq_length` frames at batch 1, each from a synthetic
scene and start frame drawn from the seed (`scene`: the camera path), with
their targets' closed-form depth; the steps cycle through them. A request
is one step; it delivers one update.

Set-up builds the step once and drives it through its first three steps on
three different windows, by the window's own call and feed; the same
object then runs the window. Output check, against the reference's three
steps on the same windows from the same weights (reference/runners.py):
`loss_gap`, the largest relative gap of the three losses; `grad_gap`, the
worst leaf's gap between the norms of the first gradient as Adam got it
(the port's from its first moment after one step), over the larger of that
leaf's reference norm and the median leaf's; `change_gap`, the same for
the parameters' change over the three steps, leaves whose reference
gradient is under 1e-3 of the median leaf's left out (moved by round-off
alone).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from portbench.harness import models
from portbench.harness.scenes import Path, make_scenes
from portbench.protocols.estm_stream import span_modules
from portbench.reference.runners import train_steps

CHECKED_STEPS = 3


@dataclasses.dataclass(frozen=True)
class Request:
    kind: str = "step"


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


def leaf_gap(port: dict, ref: dict, keep=None) -> float:
    """max over leaves of |port norm - reference norm| over the larger of
    the leaf's reference norm and the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    median = float(np.median([ref[k] for k in names]))
    return max(abs(port.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30)
               for k in names)


class Session:
    def __init__(self, cell, seed: int, device):
        from estdepth_tpu_torch.data.pipeline import prefetch_to_device
        from estdepth_tpu_torch.train.schedule import (
            warmup_multistep_schedule,
        )
        from estdepth_tpu_torch.train.trainer import (
            make_optimizer, make_train_step,
        )

        self.cell, self.device = cell, device
        cfg, mix, tr = cell.config, cell.mix, cell.config["train"]
        m = cfg["model"]
        self.batches = self._windows(cfg, mix, seed, device)
        state = models.weights(cfg, seed, device)
        self.model = models.port(cfg, state, device)
        self.optimizer, scheduler = make_optimizer(
            self.model.named_parameters(),
            warmup_multistep_schedule(tr["lr"], mix["steps_per_epoch"]),
            weight_decay=tr["weight_decay"])
        self.step = make_train_step(self.model, self.optimizer, scheduler,
                                    m["depth_min"], m["depth_max"],
                                    loss_weight=tr["loss_weight"])
        self.clip = tr["clip"]
        self.feed = prefetch_to_device(itertools.cycle(self.batches), device)
        params = dict(self.model.named_parameters())
        before = {k: p.detach().clone() for k, p in params.items()}
        self.losses = []
        for n in range(CHECKED_STEPS):
            self.losses.append(float(self.step(next(self.feed),
                                               self.clip)["loss"]))
            if n == 0:
                beta1 = self.optimizer.param_groups[0]["betas"][0]
                self.grad_norms = _norms({
                    k: self.optimizer.state[p]["exp_avg"] / (1.0 - beta1)
                    for k, p in params.items() if p in self.optimizer.state})
        self.change_norms = _norms({k: p.detach() - before[k]
                                    for k, p in params.items()})
        del before
        self.window_losses = []

    @staticmethod
    def _windows(cfg, mix, seed, device) -> list[dict]:
        """Host batches of one window each: imgs [1, V, H, W, 3] float32
        in 0..255, cam_poses, cam_intr, dmaps and dmasks [1, V-2, H, W]."""
        path = Path(height=cfg["height"], width=cfg["width"], **mix["scene"])
        v = cfg["seq_length"]
        scenes = make_scenes(path, mix["scenes"],
                             np.random.SeedSequence([seed, 1]), device)
        rng = np.random.default_rng([seed, 3])
        dmin, dmax = cfg["model"]["depth_min"], cfg["model"]["depth_max"]
        out = []
        for _ in range(mix["windows"]):
            s = scenes[int(rng.integers(len(scenes)))]
            lo = int(rng.integers(path.frames - v + 1))
            d = s.depth[lo + 1:lo + v - 1][None]
            out.append({
                "imgs": s.frames[lo:lo + v][None].astype(np.float32),
                "cam_poses": s.poses[lo:lo + v][None],
                "cam_intr": s.intr[None],
                "dmaps": d,
                "dmasks": (d > dmin) & (d < dmax) & np.isfinite(d)})
        return out

    def next_request(self) -> Request:
        return Request()

    def issue(self, req: Request):
        return self.step(next(self.feed), self.clip)["loss"]

    def fetch(self, req: Request, pending) -> int:
        self.window_losses.append(float(pending))
        return 1

    def failed(self) -> int:
        """Steps whose loss is not finite."""
        return sum(not np.isfinite(x) for x in self.window_losses)

    @staticmethod
    def end_to_end(recs, window_s: float) -> dict:
        return {"train_step_ms": 1e3 * window_s / len(recs)}

    def span_modules(self) -> dict:
        return span_modules(self.model)

    def release(self) -> None:
        del self.step, self.optimizer, self.model, self.feed
        torch.cuda.empty_cache()

    def _reference_batches(self):
        return [{k: torch.from_numpy(v).to(self.device) for k, v in b.items()}
                for b in self.batches[:CHECKED_STEPS]]

    def check(self, reference) -> list:
        tr = self.cell.config["train"]
        before = {k: p.detach().clone()
                  for k, p in reference.named_parameters()}
        losses, first = train_steps(reference, self._reference_batches(),
                                    tr["lr"], tr["weight_decay"], self.clip,
                                    tr["loss_weight"])
        grads = _norms(first)
        change = _norms({k: p.detach() - before[k]
                         for k, p in reference.named_parameters()})
        median = float(np.median(list(grads.values())))
        moved = {k for k, g in grads.items() if g >= 1e-3 * median}
        limits = self.cell.limits
        return [
            ("loss_gap", max(abs(p - r) / abs(r)
                             for p, r in zip(self.losses, losses)),
             limits["loss_gap"]["limit"]),
            ("grad_gap", leaf_gap(self.grad_norms, grads),
             limits["grad_gap"]["limit"]),
            ("change_gap", leaf_gap(self.change_norms, change, moved),
             limits["change_gap"]["limit"]),
        ]

    def flops(self, reference) -> dict:
        from torch.utils.flop_counter import FlopCounterMode

        tr = self.cell.config["train"]
        with FlopCounterMode(display=False) as fc:
            train_steps(reference, self._reference_batches()[:1], tr["lr"],
                        tr["weight_decay"], self.clip, tr["loss_weight"])
        return {"step": fc.get_total_flops()}
