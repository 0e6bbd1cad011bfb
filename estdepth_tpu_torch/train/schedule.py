"""Learning-rate schedule: linear warm-up, then multi-step decay (port of
estdepth_tpu/train/schedule.py; reference WarmupMultiStepLR,
utils/utils.py:208-252, as driven by train_hybrid.py:80-83).
"""

from __future__ import annotations

from typing import Callable, Sequence


def warmup_multistep_schedule(
    base_lr: float, steps_per_epoch: int,
    milestones_epochs: Sequence[int] = (2, 4, 6), gamma: float = 0.5,
    warmup_steps: int = 500, warmup_factor: float = 1.0 / 3.0,
) -> Callable[[int], float]:
    """step -> learning rate: from warmup_factor * base_lr linearly up to
    base_lr over warmup_steps, then times gamma at each epoch milestone.
    The rate of the first update is schedule(0). With an optimizer built at
    lr = 1 (trainer.make_optimizer) it is the `lr_lambda` of
    `torch.optim.lr_scheduler.LambdaLR`."""
    milestones = sorted(int(m * steps_per_epoch) for m in milestones_epochs)

    def schedule(step: int) -> float:
        warm = min(step / max(warmup_steps, 1), 1.0)
        mult = warmup_factor * (1.0 - warm) + warm
        decay = 1.0
        for m in milestones:
            if step >= m:
                decay *= gamma
        return base_lr * mult * decay

    return schedule
