"""Train state, optimizer and the train / eval steps (counterpart of
medicalsemseg_tpu/train/state.py).

The JAX package's ``TrainState`` pytree and its pure, jitted step become a
small mutable record and an eager step that updates it in place: the model's
parameters, ``torch.optim.AdamW``'s moments and the step counters change
under the caller's hands, and the step returns only the metrics.

The optimizer is the optax chain re-made: global-norm clipping that scales by
``max_norm / norm`` with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds
1e-6 and would differ), then AdamW(0.9, 0.95, eps 1e-6) with weight decay on
parameters of two or more dimensions only, its LR set from the per-epoch
schedule before every update; ``grad_accum_steps`` averages micro-batch
gradients and updates every k-th call, as ``optax.MultiSteps`` does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from medicalsemseg_tpu_torch.config import Config
from medicalsemseg_tpu_torch.models.layers import Dropout, DropPath
from medicalsemseg_tpu_torch.train.losses import build_loss
from medicalsemseg_tpu_torch.train.metrics import dice_per_class
from medicalsemseg_tpu_torch.train.schedule import make_epoch_schedule


@dataclass
class TrainState:
    """What a checkpoint holds and a step changes."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: torch.Generator            # DropPath / Dropout draws, on the model's device
    step: int = 0                         # train_step calls so far
    updates: int = 0                      # optimizer updates so far
    grad_accum_steps: int = 1
    gradient_clipping: Optional[float] = None
    accum: List[torch.Tensor] = field(default_factory=list)  # micro-batch sums


def weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """timm add_weight_decay semantics: decay only parameters of two or more
    dimensions (so no bias, no norm's scale or bias, BatchNorm's included;
    its running statistics are buffers, which the optimizer never sees)."""
    return {name: p.dim() > 1 for name, p in model.named_parameters()}


def make_optimizer(cfg: Config, model: nn.Module, steps_per_epoch: int
                   ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    if cfg.flat_optimizer:
        raise NotImplementedError(
            "--flat_optimizer is a TPU-side fusion of the optimizer and is "
            "not ported (ROADMAP, do not port)")
    schedule = make_epoch_schedule(cfg.lr, cfg.warmup_epochs, cfg.epochs,
                                   steps_per_epoch)
    mask = weight_decay_mask(model)
    named = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in named if mask[n]],
         "weight_decay": cfg.weight_decay},
        {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
    ]
    opt = torch.optim.AdamW(groups, lr=schedule(0), betas=(0.9, 0.95),
                            eps=1e-6)
    return opt, schedule


def create_train_state(cfg: Config, model: nn.Module, steps_per_epoch: int,
                       seed: Optional[int] = None) -> TrainState:
    """State for ``model`` where it lies; the generator of the random
    draws is seeded with ``seed`` (default ``cfg.seed``) and handed to every
    DropPath and Dropout."""
    opt, schedule = make_optimizer(cfg, model, steps_per_epoch)
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed if seed is None else seed)
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.generator = gen
    return TrainState(model=model, optimizer=opt, schedule=schedule,
                      generator=gen,
                      grad_accum_steps=max(cfg.grad_accum_steps, 1),
                      gradient_clipping=cfg.gradient_clipping)


def _deep_supervision_loss(loss_fn, heads, labels):
    """nnU-Net-style deep supervision: per-scale losses against
    nearest-downsampled labels, weights 1 / 2^i normalised."""
    weights = [1.0 / 2 ** i for i in range(len(heads))]
    total = 0.0
    for w, logits in zip(weights, heads):
        factor = labels.shape[1] // logits.shape[1]
        lab = labels[:, ::factor, ::factor, ::factor] if factor > 1 else labels
        total = total + (w / sum(weights)) * loss_fn(logits, lab)
    return total


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def _apply_update(state: TrainState, grads: List[torch.Tensor]) -> None:
    """Clip by global norm, set the epoch's LR, AdamW update."""
    if state.gradient_clipping is not None:
        max_norm = state.gradient_clipping
        norm = global_norm(grads)
        # optax.clip_by_global_norm: g if norm < max else g / norm * max
        scale = torch.where(norm < max_norm, torch.ones_like(norm),
                            max_norm / norm)
        grads = [g * scale.to(g.dtype) for g in grads]
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p, g in zip(params, grads):
        p.grad = g
    lr = state.schedule(state.updates)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.updates += 1


def make_train_step(cfg: Config):
    """Build the train step. batch keys: image (B, D, H, W, C) fp32, label
    (B, D, H, W) integer, crop_loc (B, 3), affine (B, 3), all on the model's
    device. The step updates ``state`` in place and returns ``loss``,
    ``dice_sum`` (C,), ``dice_count`` (C,) and ``grad_norm`` (the micro-batch
    gradient's global norm before clipping) as device tensors: nothing is
    read back to the host here."""
    loss_fn = build_loss(cfg)
    n_classes = cfg.output_dim

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        model_in = (batch["image"], batch.get("crop_loc"), batch.get("affine"))
        logits = model(model_in)
        if isinstance(logits, (list, tuple)):
            loss = _deep_supervision_loss(loss_fn, logits, batch["label"])
            logits = logits[0]
        else:
            loss = loss_fn(logits, batch["label"])
        grads = list(torch.autograd.grad(loss, params))
        grad_norm = global_norm(grads)

        k = state.grad_accum_steps
        if k > 1:
            if not state.accum:
                state.accum = [torch.zeros_like(g) for g in grads]
            for a, g in zip(state.accum, grads):
                a.add_(g)
            if (state.step + 1) % k == 0:
                _apply_update(state, [a / k for a in state.accum])
                state.accum = []
        else:
            _apply_update(state, grads)
        state.step += 1

        with torch.no_grad():
            pred = logits.argmax(-1)
            dice, not_nan = dice_per_class(pred, batch["label"], n_classes)
        return {"loss": loss.detach(), "dice_sum": dice.sum(0),
                "dice_count": not_nan.sum(0), "grad_norm": grad_norm}

    return train_step


def make_eval_forward(cfg: Config, model: nn.Module):
    """Deterministic forward for validation and sliding-window prediction."""

    def forward(model_in):
        model.eval()
        with torch.inference_mode():
            return model(model_in)

    return forward
