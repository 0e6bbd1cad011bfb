"""mvs_views (protocols/mvs_views.py) for a network whose readout is
winner take all, TransMVSNet's: the same scans, requests, closed loop,
fetch and reservoir sample of checked views, and an output check that an
argmax readout can pass.

An argmax moves a stage's depth by a whole hypothesis interval (up to
1 cm at stage 1) where the top two probabilities lie within rounding of
each other, so the largest depth gap over every pixel says nothing of
the arithmetic. The check therefore keeps each stage's argmax of the
checked views (the model's "stage_indices") and compares where the
port's and the reference's agree: `depth_gap_m`, the largest
|port - reference| of each stage's depth over those pixels;
`confidence_gap`, the same for the final stage's maximum probability;
`index_flip_share`, the pixels of the three stages whose argmax differs
over all their pixels. The reference's stages 2 and 3 start from the
port's previous-stage depth, as in mvs_views.

`control_numbers` gives the same numbers with the reference computed with
TF32 in the program's place, the precision below the configuration's, on
the seed's views, checked as the program is.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import models
from portbench.protocols import mvs_views
from portbench.protocols.mvs_views import Request, Views


def _maps(out) -> dict:
    """What the check keeps of a request's output dict, on the host."""
    return {"depth": out["depth"][0].cpu(),
            "confidence": out["confidence"][0].cpu(),
            "stage_depths": [d[0].cpu() for d in out["stage_depths"]],
            "stage_indices": [i[0].to(torch.uint8).cpu()
                              for i in out["stage_indices"]]}


class Session(mvs_views.Session):
    def fetch(self, req: Request, pending) -> int:
        depth = pending["depth"][0].cpu()
        confidence = pending["confidence"][0].cpu()
        self.bad += not bool(torch.isfinite(depth).all()
                             and torch.isfinite(confidence).all())
        slot = self._slot()
        if slot is not None:
            self.kept[slot] = (req, _maps(pending))
        return 1

    def span_modules(self) -> dict:
        """The feature net, ARF's deformable convolutions, the FMT with its
        pathway and each stage's 3D U-Net."""
        m = self.model
        return {**super().span_modules(), "fmt": m.fmt,
                **{f"ARF{k + 1}": a for k, a in enumerate(m.arf)}}

    def check(self, reference) -> list:
        requests, got = zip(*(self.kept[s] for s in sorted(self.kept)))
        want = reference_maps(reference, self.views, requests, got)
        return compare(got, want, self.cell.limits)


@torch.inference_mode()
def reference_maps(reference, views: Views, requests, starts=None) -> list:
    """The reference's maps of each request on the host, as `compare`
    takes them; `starts` gives each request's maps whose stage depths its
    stages 2 and 3 start from (None: its own)."""
    dev = next(reference.parameters()).device
    out = []
    for n, req in enumerate(requests):
        prev = None if starts is None else [
            d[None].to(dev) for d in starts[n]["stage_depths"][:-1]]
        out.append(_maps(reference(*(torch.as_tensor(a).to(dev)
                                     for a in views.request(req)),
                                   prev_depths=prev)))
    return out


def compare(got, want, limits) -> list:
    """The checked numbers of maps `got` against `want` (`_maps`)."""
    depth_gap = conf_gap = 0.0
    flips = pixels = 0
    for g, r in zip(got, want):
        for d, rd, i, ri in zip(g["stage_depths"], r["stage_depths"],
                                g["stage_indices"], r["stage_indices"]):
            same = i == ri
            flips += int((~same).sum())
            pixels += same.numel()
            if same.any():
                depth_gap = max(depth_gap,
                                float((d - rd).abs()[same].max()))
        same = g["stage_indices"][-1] == r["stage_indices"][-1]
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
