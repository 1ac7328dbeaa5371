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
gradients and updates every k-th call, as ``optax.MultiSteps`` does. The
JAX package's ``--flat_optimizer`` computes this same arithmetic as one pass
over flat buffers, a fusion for the TPU; here the flag takes this optimizer.

Data parallelism (:func:`distribute`): the model runs wrapped in
``DistributedDataParallel`` over the training ranks' group, each rank on its
b / dp rows of the global batch. DDP averages the gradients in the backward,
so the clip and AdamW see the global batch's gradient, as optax does under
the JAX package's sharded jit; with ``grad_accum_steps`` k the first k - 1
micro-steps run under ``no_sync()`` and the k-th all-reduces the sum. Every
BatchNorm reduces its statistics over the group, and the step returns the
global batch's metrics.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from medicalsemseg_tpu_torch.config import Config
from medicalsemseg_tpu_torch.models.layers import (
    Dropout,
    DropPath,
    set_batchnorm_group,
)
from medicalsemseg_tpu_torch.train.losses import build_loss
from medicalsemseg_tpu_torch.train.metrics import dice_per_class
from medicalsemseg_tpu_torch.train.schedule import make_epoch_schedule
from medicalsemseg_tpu_torch.utils import profiling


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
    ddp: Optional[nn.Module] = None       # the DDP wrapper of ``model``
    group: Optional[object] = None        # the training ranks' process group


def weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """timm add_weight_decay semantics: decay only parameters of two or more
    dimensions (so no bias, no norm's scale or bias, BatchNorm's included;
    its running statistics are buffers, which the optimizer never sees)."""
    return {name: p.dim() > 1 for name, p in model.named_parameters()}


def make_optimizer(cfg: Config, model: nn.Module, steps_per_epoch: int
                   ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """``torch.optim.AdamW`` over two groups (decayed, not decayed), with
    ``--flat_optimizer`` too: the JAX flat pass's numbers are these."""
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


def distribute(state: TrainState, group) -> TrainState:
    """Train ``state`` data-parallel over the process group ``group``: wrap
    the model in ``DistributedDataParallel`` (which broadcasts the first
    rank's weights and buffers) and make its BatchNorms reduce over the
    group. ``find_unused_parameters``: a parameter the loss does not reach
    (``gt_upsample`` of the last stage) must not stall the reducer. The
    BatchNorm statistics are the same on every rank, so no buffer is
    broadcast after the first."""
    from torch.nn.parallel import DistributedDataParallel

    dev = next(state.model.parameters()).device
    set_batchnorm_group(state.model, group)
    state.ddp = DistributedDataParallel(
        state.model, device_ids=[dev] if dev.type == "cuda" else None,
        process_group=group, broadcast_buffers=False,
        find_unused_parameters=True)
    state.group = group
    return state


def sync_pending_gradients(state: TrainState) -> None:
    """Average the micro-gradients that a data-parallel run has accumulated
    but not yet applied (an epoch that ends inside an accumulation) over the
    ranks, so that a checkpoint holds the same sum on every rank. The next
    synchronising step averages again; averaging is linear, so the update is
    unchanged."""
    if state.ddp is None or not state.accum:
        return
    import torch.distributed as dist

    n = dist.get_world_size(state.group)
    for a in state.accum:
        dist.all_reduce(a, group=state.group)
        a.div_(n)


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
    read back to the host here. A step is the span ``train_step``, its unit
    ``state.step``, over ``train_step.forward`` (the model's call),
    ``.loss``, ``.backward``, ``.update`` (the gradient's norm, the
    accumulation, the clip, AdamW and zeroing the gradients) and
    ``.metrics``. Under :func:`distribute` the batch is this
    rank's rows, the metrics are the global batch's, and ``grad_norm`` is
    the norm of the mean gradient accumulated so far: the ranks' average on
    a synchronising micro-step (with k = 1 on every step: the global batch's
    gradient, as in JAX), this rank's own on a ``no_sync`` one."""
    loss_fn = build_loss(cfg)
    n_classes = cfg.output_dim

    def forward_loss(module, batch):
        model_in = (batch["image"], batch.get("crop_loc"), batch.get("affine"))
        with profiling.span("train_step.forward"):
            logits = module(model_in)
        with profiling.span("train_step.loss"):
            if isinstance(logits, (list, tuple)):
                return (_deep_supervision_loss(loss_fn, logits,
                                               batch["label"]), logits[0])
            return loss_fn(logits, batch["label"]), logits

    def local_step(state, batch):
        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        loss, logits = forward_loss(state.model, batch)
        # a parameter the loss does not reach (the last stage's
        # gt_upsample under --global_token) gets a zero gradient, as in JAX
        with profiling.span("train_step.backward"):
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
                params, torch.autograd.grad(loss, params, allow_unused=True))]
        with profiling.span("train_step.update"):
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
        return loss, logits, grad_norm

    def ddp_step(state, batch):
        # the micro-gradients accumulate in .grad (``accum`` aliases them,
        # so a checkpoint holds them); DDP all-reduces at the k-th
        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        k = state.grad_accum_steps
        micro = state.step % k + 1
        if state.accum and params[0].grad is None:
            for p, a in zip(params, state.accum):
                p.grad = a
        sync = micro == k
        with contextlib.nullcontext() if sync else state.ddp.no_sync():
            loss, logits = forward_loss(state.ddp, batch)
            with profiling.span("train_step.backward"):
                loss.backward()
        with profiling.span("train_step.update"):
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            mean = [g / micro for g in grads] if micro > 1 else grads
            grad_norm = global_norm(mean)
            if sync:
                state.accum = []
                _apply_update(state, mean)
            else:
                for p, g in zip(params, grads):
                    p.grad = g
                state.accum = grads
        return loss, logits, grad_norm

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        with profiling.span("train_step", unit=state.step):
            state.model.train()
            step = local_step if state.ddp is None else ddp_step
            loss, logits, grad_norm = step(state, batch)
            state.step += 1

            with profiling.span("train_step.metrics"), torch.no_grad():
                pred = logits.argmax(-1)
                dice, not_nan = dice_per_class(pred, batch["label"], n_classes)
                out = {"loss": loss.detach(), "dice_sum": dice.sum(0),
                       "dice_count": not_nan.sum(0)}
                if state.ddp is not None:
                    out = _global_metrics(out, state.group)
            out["grad_norm"] = grad_norm
        return out

    return train_step


def _global_metrics(m: Dict[str, torch.Tensor], group
                    ) -> Dict[str, torch.Tensor]:
    """The global batch's metrics from every rank's: one all_reduce of
    [loss, dice_sum, dice_count] over the training ranks (the losses of
    equal shares averaged, the Dice sums and counts summed)."""
    import torch.distributed as dist

    n = m["dice_sum"].numel()
    flat = torch.cat([m["loss"].float().reshape(1), m["dice_sum"].float(),
                      m["dice_count"].float()])
    dist.all_reduce(flat, group=group)
    return {"loss": flat[0] / dist.get_world_size(group),
            "dice_sum": flat[1:1 + n].to(m["dice_sum"].dtype),
            "dice_count": flat[1 + n:].to(m["dice_count"].dtype)}


def make_eval_forward(cfg: Config, model: nn.Module):
    """Deterministic forward for validation and sliding-window prediction."""

    def forward(model_in):
        model.eval()
        with torch.inference_mode():
            return model(model_in)

    return forward
