"""Plain fp32 reference of a training step: MONAI's DiceCE loss and AdamW
as the configuration states them, one crop at a time.

The DiceCE of a batch is the mean of its crops' losses (the Dice term is a
mean over crops and classes, the cross entropy a mean over voxels of
equal-sized crops), so the batch's gradient is the mean of the crops'
gradients and the reference takes them crop by crop, which fits at any
batch.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F


def dice_ce(logits: torch.Tensor, labels: torch.Tensor, smooth_nr: float,
            smooth_dr: float) -> torch.Tensor:
    """MONAI DiceCELoss(softmax, to_onehot_y, squared_pred) of logits
    (B, D, H, W, C) and integer labels (B, D, H, W)."""
    n = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    target = F.one_hot(labels.long(), n).to(logits.dtype)
    axes = (1, 2, 3)
    inter = (probs * target).sum(axes)
    denom = (probs * probs).sum(axes) + target.sum(axes)
    dice = (1.0 - (2.0 * inter + smooth_nr) / (denom + smooth_dr)).mean()
    ce = -(torch.log_softmax(logits, dim=-1) * target).sum(-1).mean()
    return dice + ce


class AdamW:
    """torch's AdamW arithmetic (decoupled decay, bias corrections), with
    decay on the leaves of two or more dimensions only."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, betas=(0.9, 0.95), eps: float = 1e-6):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            if p.dim() > 1:
                p.mul_(1 - lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def train_steps(forward: Callable, params: Dict[str, torch.Tensor],
                batches: Sequence[Dict[str, torch.Tensor]],
                masks: Sequence[List], lrs: Sequence[float], flags: Dict,
                crops: Sequence[int] = ()) -> Dict:
    """Run ``len(batches)`` steps from ``params`` (fp32, left unchanged).
    ``forward(P, vol, masks)`` is the reference model; ``masks[s]`` the
    step's DropPath keep masks over the whole batch. ``crops`` restricts the
    steps to those crops (a fault's reading: the rest of the batch left
    out). Returns each step's loss, the first gradient by leaf and the
    parameters after the last step."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = AdamW(P, lrs[0], flags["weight_decay"])
    losses, first = [], None
    for s, batch in enumerate(batches):
        rows = list(crops) or list(range(batch["image"].shape[0]))
        grads = {k: torch.zeros_like(v) for k, v in P.items()}
        total = 0.0
        for b in rows:
            m = [None if t is None else t[b:b + 1] for t in masks[s]]
            logits = forward(P, batch["image"][b:b + 1].float(), m)
            loss = dice_ce(logits, batch["label"][b:b + 1],
                           flags["smooth_nr"], flags["smooth_dr"]) / len(rows)
            g = torch.autograd.grad(loss, list(P.values()), allow_unused=True)
            for (k, acc), gi in zip(grads.items(), g):
                if gi is not None:
                    acc.add_(gi)
            total += float(loss.detach())
            del logits, loss, g
        losses.append(total)
        if first is None:
            first = {k: v.clone() for k, v in grads.items()}
        opt.step(P, grads, lrs[s])
    return {"losses": losses, "first_grad": first,
            "params": {k: v.detach() for k, v in P.items()}}


def lr_at(update: int, flags: Dict, steps_per_epoch: int) -> float:
    """The learning rate of an update: the epoch-stepped linear warm-up from
    0 over ``warmup_epochs`` (the base rate reached at the last warm-up
    epoch), then cosine to 0 at ``epochs``."""
    epoch = update // max(steps_per_epoch, 1)
    base, warm, total = flags["lr"], flags["warmup_epochs"], flags["epochs"]
    if epoch < warm:
        return epoch * base / max(warm - 1, 1)
    t = (epoch - warm) / max(total - warm, 1)
    return 0.5 * base * (1.0 + math.cos(math.pi * t))
