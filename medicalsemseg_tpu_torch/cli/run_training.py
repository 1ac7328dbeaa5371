"""Training entry point (counterpart of
medicalsemseg_tpu/cli/run_training.py).

    python -m medicalsemseg_tpu_torch.cli.run_training --data_path <dir> \\
        --task <Task> --output_dir out --log_dir out/log
    torchrun --nproc_per_node N -m medicalsemseg_tpu_torch.cli.run_training ...

A full run: config -> data (cached, fold-split) -> model -> train step
(the hand-written kernels forward and backward) -> epoch loop with periodic
sliding-window validation, best-model tracking, periodic checkpoints with
end-of-run clean-up, JSON-lines logging. ``--model`` is nnFormerUNETR (the
default), GCViTUNETR, SegFormer3D or SwinSegFormer. ``--resume <file.pth>``
restores model (with BatchNorm's running statistics), optimizer, counters
and the generator of the DropPath / Dropout draws and continues with the
next epoch; ``--pretrained <file.pth>`` puts a reference-format checkpoint's
encoder weights into the fresh model first. ``--fused_loss`` computes DiceCE
through kernel K8, and at ``--n_images_per_batch`` 2 to 4 of 96^3 crops the
full-resolution convs take kernel K5 for their weight gradient
(``ops/convgrad.py``). Runs on ``--device`` (default ``cuda``);
``--device cpu`` takes the kernels' plain versions.

Under torchrun (one process per GPU) the global batch b =
``n_images_per_batch x t_n_patches_per_image`` is split over dp ranks (dp
the largest divisor of b that is at most the world size): each rank draws
b / dp crops a step from its part of the train files with seed + rank, the
model runs under DistributedDataParallel, and an epoch has the steps of the
whole file list, as the JAX package's at the same device count. Every rank
validates a share of the volumes; rank 0 alone writes checkpoints and logs.
``--profile_dir`` traces the first trained epoch (``utils/profiling.py``),
``--device_data_pipeline`` keeps the volumes on the card and crops there
(``data/device_pipeline.py``). ``--remat conv | mixed | full | none``
(default ``conv``; ``--no_remat``) picks the blocks' rematerialisation
(``models/layers.py`` ``checkpoint_block``); ``--flat_optimizer`` runs the
same AdamW as without it (``train/state.py``).
"""

from __future__ import annotations

import datetime
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from medicalsemseg_tpu_torch.config import Config, get_args, resolve_device
from medicalsemseg_tpu_torch.data.datalist import (
    build_cv_file_lists,
    partition_dataset,
    save_decathlon_datalist,
)
from medicalsemseg_tpu_torch.data.dataset import (
    CachedVolumeDataset,
    EvalLoader,
    TrainLoader,
    rank_share,
)
from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
from medicalsemseg_tpu_torch.parallel import dist as pdist
from medicalsemseg_tpu_torch.parallel.mesh import create_mesh, replicated
from medicalsemseg_tpu_torch.train.loop import run_validation, train_one_epoch
from medicalsemseg_tpu_torch.train.state import (
    create_train_state,
    distribute,
    make_train_step,
    sync_pending_gradients,
)
from medicalsemseg_tpu_torch.utils import checkpoint as ckpt
from medicalsemseg_tpu_torch.utils.params import load_pretrained_encoder
from medicalsemseg_tpu_torch.utils.profiling import (
    enable_anomaly_detection,
    trace,
)
from medicalsemseg_tpu_torch.utils.tags import experiment_tags, log_metrics

class JsonlWriter:
    """Minimal scalar sink (a tensorboard stand-in; scalars are logged at
    epoch_1000x)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.logdir = log_dir
        self.path = os.path.join(log_dir, "scalars.jsonl")

    def add_scalar(self, tag: str, value, step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(step)}) + "\n")

    def flush(self):
        pass


def main(cfg: Config) -> dict:
    if cfg.input_dim != 3:
        raise ValueError("the CLIs feed 3D volumes only (--input_dim 3)")
    device = pdist.init_distributed_mode(cfg, resolve_device(cfg.device))
    rank, main_process = pdist.get_rank(), pdist.is_main_process()
    if cfg.anomaly_detection:
        enable_anomaly_detection()

    seed = cfg.seed + rank
    log_writer = JsonlWriter(cfg.log_dir) if cfg.log_dir and main_process \
        else None
    if cfg.log_dir and main_process:
        log_metrics(cfg.log_dir, {
            "tags": experiment_tags(cfg),
            "parameters": {k: (list(v) if isinstance(v, tuple) else v)
                           for k, v in vars(cfg).items()
                           if isinstance(v, (int, float, str, bool, tuple,
                                             type(None)))},
        })

    # -- data: CV split, the training ranks' parts, host-memory cache --
    train_files, val_files = build_cv_file_lists(cfg)
    if main_process:
        save_decathlon_datalist(
            os.path.join(cfg.data_path, cfg.task, cfg.json_list),
            train_files, val_files, cfg.log_dir)
    mesh = create_mesh(cfg.n_images_per_batch * cfg.t_n_patches_per_image,
                       cfg.mesh_shape)
    steps = max(len(train_files) // cfg.n_images_per_batch, 1)
    # one training rank: the loader's own count (the same, and its order
    # is the JAX package's for a list shorter than a batch)
    rank_steps = steps if mesh.dp > 1 else None
    cfg_rank = rank_share(cfg, mesh.dp)
    train_part = (partition_dataset(train_files, mesh.dp,
                                    even_divisible=True)[rank]
                  if mesh.trains else [])
    print(f"rank {rank}: {len(train_part)} train / {len(val_files)} val "
          f"volumes, {cfg_rank.n_images_per_batch} x "
          f"{cfg_rank.t_n_patches_per_image} crops a step")
    ds_train = CachedVolumeDataset(
        train_part, cfg, cfg.cache_rate_train if cfg.cache_dataset else 0.0,
        mode="train")
    ds_val = CachedVolumeDataset(
        val_files, cfg, cfg.cache_rate_val if cfg.cache_dataset else 0.0,
        mode="val")
    if cfg.device_data_pipeline:
        from medicalsemseg_tpu_torch.data.device_pipeline import (
            DeviceCachedDataset,
            DeviceTrainLoader,
        )

        loader_train = DeviceTrainLoader(
            DeviceCachedDataset(ds_train, cfg_rank, device), cfg_rank,
            seed=seed, steps=rank_steps)
        print("device data pipeline: volumes cached on the card")
    else:
        loader_train = TrainLoader(ds_train, cfg_rank, seed=seed,
                                   steps=rank_steps)
    loader_val = EvalLoader(ds_val)

    # -- model + state --
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = replicated(model.to(device))
    state = create_train_state(cfg, model, steps, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model = {cfg.model}, params = {n_params / 1e6:.2f}M")

    pin = cfg.pin_mem and device.type == "cuda"

    def put_batch(batch):
        out = {}
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):  # the device pipeline's
                out[k] = v.to(device)
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory() if pin else t).to(device,
                                                       non_blocking=pin)
        return out

    train_step = make_train_step(cfg)

    start_epoch = cfg.start_epoch
    if cfg.pretrained:
        keys = load_pretrained_encoder(model, cfg.pretrained)
        print(f"Loaded pretrained encoder from {cfg.pretrained} "
              f"({len(keys)} tensors)")
    if cfg.resume:
        state, start_epoch = ckpt.load_checkpoint(cfg.resume, state)
        print(f"Resumed from {cfg.resume} at epoch {start_epoch}")
    if mesh.dp > 1 and mesh.trains:
        state = distribute(state, mesh.group)
    else:   # a lone training rank sums its meters over itself
        state.group = mesh.group

    best_val_metric, best_epoch = 0.0, 0
    checkpoint_paths = []
    start_time = time.time()

    for epoch in range(start_epoch, cfg.epochs):
        log_stats = {"epoch": epoch}
        if mesh.trains:
            # a trace of the first trained epoch when --profile_dir is set
            with trace(cfg.profile_dir if epoch == start_epoch else None):
                state, train_stats = train_one_epoch(
                    state, train_step, loader_train, epoch, cfg,
                    log_writer=log_writer, put_batch=put_batch)
            sync_pending_gradients(state)
            log_stats = {**train_stats, "epoch": epoch}
        save = cfg.output_dir and main_process

        if not (epoch + 1) % cfg.val_interval:
            if mesh.dp < mesh.world:  # ranks that sat out take the weights
                replicated(state.model)
            val_stats = run_validation(state, loader_val, cfg, epoch,
                                       log_writer=log_writer)
            log_stats.update(val_stats)
            if val_stats["val/mDice"] > best_val_metric:
                print(f"New record at epoch {epoch}! Previous best: "
                      f"{best_val_metric}, new best: {val_stats['val/mDice']}")
                best_val_metric, best_epoch = val_stats["val/mDice"], epoch
                if save:
                    ckpt.save_checkpoint(cfg.output_dir, "best_model", state,
                                         epoch)

        if save and ((epoch + 1) % cfg.save_ckpt_freq == 0
                     or epoch + 1 == cfg.epochs):
            checkpoint_paths.append(ckpt.save_checkpoint(
                cfg.output_dir, f"checkpoint-{epoch}", state, epoch))

        if save:
            with open(os.path.join(cfg.output_dir, "log.txt"), "a",
                      encoding="utf-8") as f:
                f.write(json.dumps(log_stats) + "\n")
        if cfg.log_dir and main_process:
            log_metrics(cfg.log_dir, log_stats)

    total = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    print(f"Training complete! Total training time {total}. "
          f"Best validation metric {best_val_metric} at epoch {best_epoch}")
    ckpt.cleanup_checkpoints(checkpoint_paths)
    return {"best_val_metric": best_val_metric, "best_epoch": best_epoch}


if __name__ == "__main__":
    args = get_args()
    if args.output_dir:
        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    try:
        main(args)
    finally:
        pdist.shutdown()
