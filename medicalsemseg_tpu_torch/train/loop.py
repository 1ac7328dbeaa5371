"""Epoch-level train and validation loops (counterpart of
medicalsemseg_tpu/train/loop.py).

The per-step work is ``train.state.make_train_step``; this module owns the
host side: batches onto the device, metric smoothing, the finiteness guard,
logging. Per-step metrics accumulate in a small device-side window and are
read back every ``cfg.metric_readback_freq`` steps, so the host does not
wait for the card after every step; the global averages equal per-step
accounting, and a non-finite loss stops the run within one window.

Over several processes a data-parallel step returns the global batch's
metrics, so the windows and the logged train Dice are the global batch's;
validation spreads whole volumes over the ranks
(``infer.sliding_window.rank_volumes``) and sums the meters over them.
"""

from __future__ import annotations

import math
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

from medicalsemseg_tpu_torch.config import Config
from medicalsemseg_tpu_torch.infer.sliding_window import (
    rank_volumes,
    sliding_window_inference,
)
from medicalsemseg_tpu_torch.parallel.dist import get_rank, get_world_size
from medicalsemseg_tpu_torch.train.losses import build_loss
from medicalsemseg_tpu_torch.train.metrics import dice_per_class
from medicalsemseg_tpu_torch.train.schedule import warmup_cosine_lr
from medicalsemseg_tpu_torch.train.state import TrainState, make_eval_forward
from medicalsemseg_tpu_torch.utils import profiling
from medicalsemseg_tpu_torch.utils.logger import MetricLogger, SmoothedValue


def _class_meter_names(n: int):
    return [f"class{c}Dice" for c in range(n)]


def _metric_window(m: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One step's metrics as window sums (device tensors, no readback):
    per-class step means and presence counts, the step's mDice, the loss, and
    a finiteness flag that the window multiplies up."""
    cnt = m["dice_count"]
    step_mean = torch.where(cnt > 0, m["dice_sum"] / torch.clamp(cnt, min=1),
                            torch.zeros_like(cnt))
    present = (cnt > 0).float()
    any_present = (present.sum() > 0).float()
    mdice = any_present * step_mean.sum() / torch.clamp(present.sum(), min=1)
    return {"loss_sum": m["loss"].float(), "n": torch.ones_like(any_present),
            "class_mean_sum": step_mean, "class_present": present,
            "mdice_sum": mdice, "mdice_n": any_present,
            "finite": torch.isfinite(m["loss"]).float()}


def _metric_window_add(acc, m):
    step = _metric_window(m)
    out = {k: acc[k] + step[k] for k in acc}
    out["finite"] = acc["finite"] * step["finite"]
    return out


def train_one_epoch(state: TrainState, train_step, loader, epoch: int,
                    cfg: Config, log_writer=None,
                    put_batch: Optional[Callable] = None):
    """One epoch over the crop loader; returns (state, {'train/...': global
    averages})."""
    logger = MetricLogger()
    for name in ["lr", "loss", "mDice"] + _class_meter_names(cfg.output_dim):
        logger.add_meter(name, SmoothedValue(100, "{value:.6f}"))
    header = f"Epoch: [{epoch}]"
    steps = loader.steps_per_epoch()
    freq = max(int(cfg.metric_readback_freq), 1)
    class_names = _class_meter_names(cfg.output_dim)

    def flush(acc, it):
        host = {k: v.cpu().numpy() for k, v in acc.items()}
        n = int(host["n"])
        loss_mean = float(host["loss_sum"]) / max(n, 1)
        if not host["finite"] or not math.isfinite(loss_mean):
            # hard stop on divergence
            print(f"Loss is {loss_mean} (finite={bool(host['finite'])}), "
                  "stopping training")
            sys.exit(1)
        lr = warmup_cosine_lr(epoch, cfg.lr, cfg.warmup_epochs, cfg.epochs)
        logger.meters["loss"].update(loss_mean, n=n)
        logger.meters["lr"].update(lr)
        if host["mdice_n"] > 0:
            logger.meters["mDice"].update(
                float(host["mdice_sum"]) / host["mdice_n"],
                n=int(host["mdice_n"]))
        for c, name in enumerate(class_names):
            pc = host["class_present"][c]
            if pc > 0:
                logger.meters[name].update(
                    float(host["class_mean_sum"][c]) / pc, n=int(pc))
        if log_writer is not None:
            epoch_1000x = int((it / max(steps, 1) + epoch) * 1000)
            log_writer.add_scalar("train_loss", loss_mean, epoch_1000x)
            log_writer.add_scalar("lr", lr, epoch_1000x)
            if host["mdice_n"] > 0:
                log_writer.add_scalar(
                    "train_mDice",
                    float(host["mdice_sum"]) / host["mdice_n"], epoch_1000x)

    acc = None
    for it, batch in enumerate(logger.log_every(loader.epoch(epoch), freq,
                                                header, total=steps)):
        if put_batch is not None:
            batch = put_batch(batch)
        metrics = train_step(state, batch)
        with profiling.span("train_one_epoch.metric_window"):
            acc = _metric_window(metrics) if acc is None else \
                _metric_window_add(acc, metrics)
        if (it + 1) % freq == 0 or it + 1 == steps:
            with profiling.span("train_one_epoch.readback"):
                flush(acc, it)
            acc = None
    if acc is not None:  # the loader yielded more steps than advertised
        with profiling.span("train_one_epoch.readback"):
            flush(acc, steps - 1)

    logger.synchronize_between_processes(state.group)
    print("Training averaged stats:", logger.log_all_average())
    return state, {f"train/{k}": m.global_avg for k, m in logger.meters.items()}


def valid_extent_mask(shape, orig, device=None) -> torch.Tensor:
    """(B, D', H', W') bool mask of the leading ``orig`` = (3,) extents."""
    axes = [torch.arange(s, device=device) < int(o)
            for s, o in zip(shape[1:], orig)]
    return (axes[0][:, None, None] & axes[1][None, :, None]
            & axes[2][None, None, :]).expand(shape)


def make_val_metrics(loss_fn, n_cls: int):
    """(logits, labels, orig) -> (loss, per-class dice, not_nan) at the
    bucket-padded shape, the pad voxels excluded exactly by the masks."""

    def val_metrics(logits, labels, orig):
        mask = valid_extent_mask(logits.shape[:-1], orig, logits.device)
        loss = loss_fn(logits, labels, mask=mask)
        dice, not_nan = dice_per_class(logits.argmax(-1), labels, n_cls,
                                       mask=mask)
        return loss, dice[0], not_nan[0]

    return val_metrics


def run_validation(state: TrainState, loader, cfg: Config, epoch: int,
                   log_writer=None) -> Dict[str, float]:
    """Whole-volume sliding-window validation: loss and per-class Dice.
    Over several processes every rank predicts its share of the volumes
    whole (``--val_group_policy`` picks the shares, as in the JAX package)
    and the meters are summed over the ranks; every rank must call it with
    the same weights."""
    loss_fn = build_loss(cfg)
    n_cls = cfg.output_dim
    device = next(state.model.parameters()).device
    # padding value for air under normalisation
    cval = (0.0 - cfg.t_norm_mean) / cfg.t_norm_std if cfg.t_normalize else 0.0
    forward = make_eval_forward(cfg, state.model)
    val_metrics = make_val_metrics(loss_fn, n_cls)

    logger = MetricLogger()
    for name in ["loss", "mDice"] + _class_meter_names(n_cls):
        logger.add_meter(name, SmoothedValue(100, "{value:.6f}"))

    def volume_metrics(logits, sample, orig):
        lab = sample.label[..., 0].astype(np.int64)
        pads = [(0, logits.shape[1 + i] - lab.shape[i]) for i in range(3)]
        labels = torch.from_numpy(np.pad(lab, pads))[None].to(device)
        loss, dice, not_nan = val_metrics(logits, labels, orig)
        dice, not_nan = dice.cpu().numpy(), not_nan.cpu().numpy()
        kw = {name: dice[c] for c, name in enumerate(_class_meter_names(n_cls))
              if not_nan[c] > 0}
        mdice = dice[not_nan > 0].mean() if (not_nan > 0).any() else np.nan
        logger.update(loss=float(loss), mDice=mdice, **kw)

    world = get_world_size()
    volumes = rank_volumes(loader, get_rank(), world, cfg.sw_bucket_multiple,
                           cval, cfg.val_group_policy)
    for _, sample, padded, orig in logger.log_every(
            volumes, 5, f"Val: [{epoch}]", total=-(-len(loader) // world)):
        vol = torch.from_numpy(padded)[None].to(device)
        affine_xyz = torch.from_numpy(
            np.diag(sample.original_affine)[:3].astype(np.float32))[None]
        with torch.inference_mode():
            logits = sliding_window_inference(
                vol, affine_xyz.to(device), cfg.vol_size3(), cfg.sw_batch_size,
                forward, n_cls, overlap=cfg.val_infer_overlap,
                mode="gaussian", cval=cval)
            volume_metrics(logits, sample, orig)

    logger.synchronize_between_processes()
    print("Validation averaged stats:", logger.log_all_average())
    stats = {f"val/{k}": m.global_avg for k, m in logger.meters.items()}
    if log_writer is not None:
        log_writer.add_scalar("val_loss", stats["val/loss"], epoch)
        log_writer.add_scalar("val_mDice", stats["val/mDice"], epoch)
        for name in _class_meter_names(n_cls):
            if logger.meters[name].count > 0:
                log_writer.add_scalar(f"val_{name}", stats[f"val/{name}"],
                                      epoch)
    return stats
