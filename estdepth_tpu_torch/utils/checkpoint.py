"""Checkpoint save and resume (port of estdepth_tpu/utils/checkpoint.py;
reference train_hybrid.py:137-151,312-347): periodic and per-epoch saves,
resume from the latest, and partial restore (the shape-filtered load and
the encoder-only restore, :331-347) as state_dict merges.

A checkpoint is one file `step_<n>.pt` written by `torch.save`:
`{"model", "optimizer", "scheduler"}` state_dicts and `"step"`. It holds
tensors, numbers, lists and dicts only, so it loads with
`torch.load(weights_only=True)`. The model's state_dict names are the
reference's, so `"model"` is also a reference checkpoint's state_dict.

In a data-parallel run every rank calls `save`; rank 0 alone writes (the
reference's rank-0 torch.save, train_hybrid.py:188) and a barrier follows,
so no rank reads or prunes a checkpoint before it is whole. The model's
state_dict is the unwrapped module's (no DDP `module.` prefix), so a
checkpoint of any number of ranks loads into a one-device model.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
from torch.nn.parallel import DistributedDataParallel

from estdepth_tpu_torch.parallel.mesh import barrier, process_index
from estdepth_tpu_torch.train.trainer import TrainState

_NAME = re.compile(r"step_(\d+)\.pt$")


def _unwrap(model: torch.nn.Module) -> torch.nn.Module:
    return model.module if isinstance(model, DistributedDataParallel) \
        else model


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        """Write `state` as step `step` (atomically: a temporary file,
        then a rename) and drop the oldest beyond max_to_keep; on rank 0
        only, and every rank waits for it."""
        if process_index() == 0:
            blob = {"model": _unwrap(state.model).state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "scheduler": state.scheduler.state_dict(),
                    "step": int(step)}
            tmp = self.path(step) + ".tmp"
            torch.save(blob, tmp)
            os.replace(tmp, self.path(step))
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        barrier()

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load step `step` (default: the latest) into `state`'s model,
        optimizer and scheduler, in place; returns `state`."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        device = next(state.model.parameters()).device
        blob = torch.load(self.path(step), map_location=device,
                          weights_only=True)
        _unwrap(state.model).load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.scheduler.load_state_dict(blob["scheduler"])
        state.step = int(blob["step"])
        return state


def load_weights_for_finetune(path: str) -> dict[str, torch.Tensor]:
    """A model state_dict from a checkpoint directory written by
    tools/train.py (its latest step) or from a reference .ckpt file (a
    state_dict, bare or under "model"): the `--loadckpt` source
    (train_hybrid.py:325-347). Files are read with `weights_only=True`: a
    .ckpt whose pickle holds more than tensors, numbers and containers is
    refused and has to be saved again as a plain state_dict."""
    if os.path.isdir(path):
        mgr = CheckpointManager(path)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        path = mgr.path(step)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and isinstance(blob.get("model"), dict):
        blob = blob["model"]
    return blob


def partial_restore(target: dict[str, torch.Tensor],
                    loaded: dict[str, torch.Tensor],
                    verbose: bool = True) -> dict[str, torch.Tensor]:
    """`target` with every entry replaced by `loaded`'s where the name and
    the shape match: the reference's shape-filtered partial load
    (train_hybrid.py:331-337). Anything missing or mismatched keeps the
    target's value. Feed the result to `load_state_dict`."""
    merged, hits = {}, 0
    for name, value in target.items():
        cand = loaded.get(name)
        if cand is not None and tuple(cand.shape) == tuple(value.shape):
            merged[name] = cand
            hits += 1
        else:
            merged[name] = value
    if verbose:
        print(f"partial_restore: {hits}/{len(target)} tensors restored")
    return merged
