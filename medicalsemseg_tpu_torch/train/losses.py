"""Dice-family segmentation losses (counterpart of
medicalsemseg_tpu/train/losses.py; MONAI semantics).

All losses take fp32 logits (B, D, H, W, n_classes) channels-last and integer
labels (B, D, H, W) and reduce to a scalar in fp32. Every loss accepts an
optional 0/1 ``mask`` (B, D, H, W): a masked loss equals the unmasked loss
over the mask's bounding-box slice, which is how validation scores
bucket-padded volumes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.config import Config
from medicalsemseg_tpu_torch.ops.kernels.dice_ce import dice_ce_fused

_SPATIAL = (1, 2, 3)


def _onehot(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    return F.one_hot(labels.long(), n_classes).float()


def _masked_mean(x: torch.Tensor, mask) -> torch.Tensor:
    """Mean over voxels; with a 0/1 mask, over the masked voxels only."""
    if mask is None:
        return x.mean()
    m = mask.float()
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def dice_loss(logits, labels, squared_pred: bool = True,
              smooth_nr: float = 1e-5, smooth_dr: float = 1e-5, mask=None):
    """MONAI DiceLoss(softmax, to_onehot_y, include_background)."""
    probs = torch.softmax(logits.float(), dim=-1)
    target = _onehot(labels, logits.shape[-1])
    if mask is not None:
        m = mask.float()[..., None]
        probs, target = probs * m, target * m
    inter = (probs * target).sum(_SPATIAL)
    if squared_pred:
        denom = (probs ** 2).sum(_SPATIAL) + (target ** 2).sum(_SPATIAL)
    else:
        denom = probs.sum(_SPATIAL) + target.sum(_SPATIAL)
    return (1.0 - (2.0 * inter + smooth_nr) / (denom + smooth_dr)).mean()


def cross_entropy_loss(logits, labels, mask=None):
    """torch.nn.CrossEntropyLoss (mean over voxels, or the masked ones)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -(logp * _onehot(labels, logits.shape[-1])).sum(-1)
    return _masked_mean(nll, mask)


def dice_ce_loss(logits, labels, squared_pred: bool = True,
                 smooth_nr: float = 1e-5, smooth_dr: float = 1e-5,
                 lambda_dice: float = 1.0, lambda_ce: float = 1.0, mask=None):
    """MONAI DiceCELoss = lambda_dice * Dice + lambda_ce * CE."""
    return (lambda_dice * dice_loss(logits, labels, squared_pred, smooth_nr,
                                    smooth_dr, mask=mask)
            + lambda_ce * cross_entropy_loss(logits, labels, mask=mask))


def tversky_loss(logits, labels, alpha: float = 0.5, beta: float = 0.5,
                 smooth_nr: float = 1e-5, smooth_dr: float = 1e-5, mask=None):
    """MONAI TverskyLoss(softmax, to_onehot_y)."""
    p0 = torch.softmax(logits.float(), dim=-1)
    g0 = _onehot(labels, logits.shape[-1])
    m = (torch.ones(p0.shape[:-1], device=p0.device) if mask is None
         else mask.float())[..., None]
    tp = (p0 * g0 * m).sum(_SPATIAL)
    fp = alpha * (p0 * (1.0 - g0) * m).sum(_SPATIAL)
    fn = beta * ((1.0 - p0) * g0 * m).sum(_SPATIAL)
    return (1.0 - (tp + smooth_nr) / (tp + fp + fn + smooth_dr)).mean()


def focal_loss(logits, labels, gamma: float = 2.0, mask=None):
    """MONAI FocalLoss(include_background, to_onehot_y): mean over voxels of
    the per-voxel sum of -(1 - p)^gamma * log(p) with one-hot targets."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    target = _onehot(labels, logits.shape[-1])
    cell = -target * ((1.0 - torch.exp(logp)) ** gamma) * logp
    return _masked_mean(cell.sum(-1), mask)


def dice_focal_loss(logits, labels, gamma: float = 2.0,
                    squared_pred: bool = True, smooth_nr: float = 1e-5,
                    smooth_dr: float = 1e-5, mask=None):
    """MONAI DiceFocalLoss."""
    return (dice_loss(logits, labels, squared_pred, smooth_nr, smooth_dr,
                      mask=mask)
            + focal_loss(logits, labels, gamma, mask=mask))


def build_loss(cfg: Config):
    """--loss_fn name -> loss(logits, labels, mask=None)."""
    if cfg.loss_fn == "DiceCE":
        if cfg.fused_loss:
            # kernel K8; it has no masked form, so validation's masked loss
            # stays unfused. Other --loss_fn values ignore the flag.
            return lambda lg, lb, mask=None: (
                dice_ce_fused(lg, lb, True, cfg.smooth_nr, cfg.smooth_dr)
                if mask is None else
                dice_ce_loss(lg, lb, smooth_nr=cfg.smooth_nr,
                             smooth_dr=cfg.smooth_dr, mask=mask))
        return lambda lg, lb, mask=None: dice_ce_loss(
            lg, lb, smooth_nr=cfg.smooth_nr, smooth_dr=cfg.smooth_dr,
            mask=mask)
    if cfg.loss_fn == "Tversky":
        return lambda lg, lb, mask=None: tversky_loss(
            lg, lb, alpha=cfg.tversky_alpha, beta=cfg.tversky_beta,
            smooth_nr=cfg.smooth_nr, smooth_dr=cfg.smooth_dr, mask=mask)
    if cfg.loss_fn == "DiceFocal":
        return lambda lg, lb, mask=None: dice_focal_loss(
            lg, lb, smooth_nr=cfg.smooth_nr, smooth_dr=cfg.smooth_dr,
            mask=mask)
    raise ValueError(f"unknown loss_fn {cfg.loss_fn!r}; "
                     "available: DiceCE, Tversky, DiceFocal")
