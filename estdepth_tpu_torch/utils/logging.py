"""Scalar logging and meters (the port's own copy of
estdepth_tpu/utils/logging.py: numpy- and framework-free).

Equivalents of DictAverageMeter and save_scalars (reference
utils/utils.py:70-122) without the tensorboardX dependency: scalars go to
a JSONL file, and to TensorBoard too when that package is installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class DictAverageMeter:
    """Running mean of a dict of scalars (utils/utils.py:103-122)."""

    def __init__(self):
        self.sums: Dict[str, float] = {}
        self.count = 0

    def update(self, scalars: Dict[str, float]):
        for k, v in scalars.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v)
        self.count += 1

    def mean(self) -> Dict[str, float]:
        return {k: v / max(self.count, 1) for k, v in self.sums.items()}

    def reset(self):
        self.sums.clear()
        self.count = 0


class ScalarLogger:
    """JSONL scalar logger with an optional TensorBoard mirror."""

    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "scalars.jsonl")
        self._file = open(self.path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(logdir)
            except Exception:
                self._tb = None

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "train"):
        rec = {"step": step, "time": time.time()}
        rec.update({f"{prefix}/{k}": float(v) for k, v in scalars.items()})
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)

    def close(self):
        self._file.close()
        if self._tb is not None:
            self._tb.close()
