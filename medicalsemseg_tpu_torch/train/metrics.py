"""Per-class Dice (counterpart of medicalsemseg_tpu/train/metrics.py
``dice_per_class`` and ``mean_dice``; MONAI DiceMetric semantics). The 95 %
Hausdorff distance is not ported yet."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_SPATIAL = (1, 2, 3)


def dice_per_class(pred_labels: torch.Tensor, true_labels: torch.Tensor,
                   n_classes: int, mask=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, D, H, W) int predictions/labels -> ((B, C) dice, (B, C) not_nan).

    dice is 0 where not_nan is 0 (the class is absent from the ground
    truth). An optional 0/1 ``mask`` (B, D, H, W) restricts all counts to the
    masked voxels."""
    p = F.one_hot(pred_labels.long(), n_classes).float()
    g = F.one_hot(true_labels.long(), n_classes).float()
    if mask is not None:
        m = mask.float()[..., None]
        p, g = p * m, g * m
    inter = (p * g).sum(_SPATIAL)
    p_o, g_o = p.sum(_SPATIAL), g.sum(_SPATIAL)
    not_nan = (g_o > 0).float()
    denom = p_o + g_o
    dice = torch.where(denom > 0, 2.0 * inter / torch.clamp(denom, min=1.0),
                       torch.zeros_like(denom))
    return dice * not_nan, not_nan


def mean_dice(dice: torch.Tensor, not_nan: torch.Tensor) -> torch.Tensor:
    """NaN-aware mean over the batch, then over the classes that occur."""
    counts = not_nan.sum(0)
    means = dice.sum(0) / torch.clamp(counts, min=1.0)
    valid = counts > 0
    return (torch.where(valid, means, torch.zeros_like(means)).sum()
            / torch.clamp(valid.sum(), min=1))
