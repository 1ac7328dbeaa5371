"""Learning-rate schedule (counterpart of
medicalsemseg_tpu/train/schedule.py): the reference's epoch-stepped
LinearWarmupCosineAnnealingLR. lr(0) = warmup_start, linear so that the base
LR is reached at epoch warmup_epochs - 1, then cosine to eta_min at
max_epochs. With ``warmup_epochs > 0`` the LR is 0 during epoch 0.
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_cosine_lr(epoch: int, base_lr: float, warmup_epochs: int,
                     max_epochs: int, warmup_start_lr: float = 0.0,
                     eta_min: float = 0.0) -> float:
    """LR of an epoch index."""
    e = float(epoch)
    if e < warmup_epochs:
        return (warmup_start_lr + e * (base_lr - warmup_start_lr)
                / max(warmup_epochs - 1, 1))
    t = (e - warmup_epochs) / max(max_epochs - warmup_epochs, 1)
    return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * t))


def make_epoch_schedule(base_lr: float, warmup_epochs: int, max_epochs: int,
                        steps_per_epoch: int) -> Callable[[int], float]:
    """Step-indexed schedule that holds the epoch's LR within each epoch."""

    def schedule(step: int) -> float:
        return warmup_cosine_lr(int(step) // max(steps_per_epoch, 1), base_lr,
                                warmup_epochs, max_epochs)

    return schedule
