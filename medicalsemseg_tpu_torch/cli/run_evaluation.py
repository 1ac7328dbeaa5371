"""Labelled evaluation (counterpart of
medicalsemseg_tpu/cli/run_evaluation.py).

    python -m medicalsemseg_tpu_torch.cli.run_evaluation --data_path <dir> \\
        --task <Task> --resume model.pth [--device_hd95] [--tta_mirror] \\
        [--save_eval_output --output_dir out]

Takes the flags of ``medicalsemseg_tpu_torch.config``. Loads the
``validation`` datalist, runs Gaussian sliding-window inference of
``--model`` with the hand-written kernels (``--batch_size_val`` windows a
predictor call, ``--tta_mirror`` averaging the 8 flips), then per volume:
the argmax and the per-class Dice on the card at the bucket-padded shape
under the valid-extent mask, and the 95 % Hausdorff distance of the cropped
prediction (foreground classes; ``--device_hd95`` computes its distances on
the card, bit-identical to the host's). Prints per-volume scores, per-class
Dice (sums over counts, NaN for absent classes) and HD95 (mean of the finite
values) and their means. ``--save_eval_output`` writes
``eval_output/Fold{k}/{pred,img,gt}`` with the sample's affine as it is.
``--resume`` is a torch checkpoint of the port or of the reference.
Under ``torchrun --nproc_per_node N`` every rank scores whole volumes of
its own on its card (``--val_group_policy`` picks which, as in the JAX
package) and the per-volume scores are gathered (``all_gather_object``) in
the datalist's order before the means, so they are a one-process run's.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from medicalsemseg_tpu_torch.config import Config, get_args, resolve_device
from medicalsemseg_tpu_torch.data import nifti
from medicalsemseg_tpu_torch.data.datalist import load_decathlon_datalist
from medicalsemseg_tpu_torch.data.dataset import (
    CachedVolumeDataset,
    EvalLoader,
)
from medicalsemseg_tpu_torch.infer.sliding_window import (
    rank_volumes,
    sliding_window_inference,
)
from medicalsemseg_tpu_torch.infer.tta import mirror_tta
from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
from medicalsemseg_tpu_torch.parallel import dist as pdist
from medicalsemseg_tpu_torch.train.loop import valid_extent_mask
from medicalsemseg_tpu_torch.train.metrics import dice_per_class, hausdorff95
from medicalsemseg_tpu_torch.utils.params import load_checkpoint


def eval_model(model: torch.nn.Module, loader, cfg: Config,
               device: torch.device) -> Dict:
    """Score every volume of ``loader``. Returns ``mDice`` and ``mHD95``,
    the per-class ``class_dice`` and ``class_hd95``, the per-volume HD95
    rows ``hd95`` (volumes x foreground classes) and one record a volume:
    name, windows, predictor calls (model forwards: 8 a window batch with
    ``--tta_mirror``), ``predict_seconds`` (the preprocessed volume to the
    label map and Dice on the host), ``hd95_seconds`` and ``seconds`` (with
    the files written)."""
    n_cls = cfg.output_dim
    air_cval = ((0.0 - cfg.t_norm_mean) / cfg.t_norm_std
                if cfg.t_normalize else 0.0)
    scored = []   # (index in the datalist, dice, not-nan, HD95, record)
    for i, sample, padded, orig in rank_volumes(
            loader, pdist.get_rank(), pdist.get_world_size(),
            cfg.sw_bucket_multiple, air_cval, cfg.val_group_policy):
        t0 = time.perf_counter()
        calls, windows = 0, 0

        def forward(model_in):
            nonlocal calls
            calls += 1
            return model(model_in)

        tta = mirror_tta(forward) if cfg.tta_mirror else forward

        def predictor(model_in):
            nonlocal windows
            windows += model_in[0].shape[0]
            return tta(model_in)

        vol = torch.from_numpy(padded)[None].to(device)
        aff = torch.from_numpy(
            np.diag(sample.original_affine)[:3].astype(np.float32))[None]
        logits = sliding_window_inference(
            vol, aff.to(device), cfg.vol_size3(), cfg.batch_size_val,
            predictor, n_cls, overlap=cfg.val_infer_overlap, mode="gaussian",
            cval=air_cval)
        # argmax and Dice at the padded shape; the label zero-padded and the
        # pad voxels left out by the mask
        gt = sample.label[..., 0].astype(np.int32)
        pads = [(0, logits.shape[1 + k] - gt.shape[k]) for k in range(3)]
        labels = torch.from_numpy(np.pad(gt, pads))[None].to(device)
        mask = valid_extent_mask(logits.shape[:-1], orig, device)
        pred_dev = logits.argmax(-1)
        dice, nn = dice_per_class(pred_dev, labels, n_cls, mask=mask)
        pred = pred_dev[0, :orig[0], :orig[1], :orig[2]].to(
            torch.uint8).cpu().numpy()
        dice, nn = dice[0].cpu().numpy(), nn[0].cpu().numpy()
        predict_seconds = time.perf_counter() - t0

        t1 = time.perf_counter()
        hd = hausdorff95(pred, gt, n_cls, include_background=False,
                         device=cfg.device_hd95, on=device)
        hd95_seconds = time.perf_counter() - t1
        finite_hd = hd[np.isfinite(hd)]
        name = os.path.basename(sample.name)
        print(f"[{i}] {name}: mDice {dice[nn > 0].mean():.4f} HD95 "
              f"{finite_hd.mean() if len(finite_hd) else float('nan'):.2f}")

        if cfg.save_eval_output and cfg.output_dir:
            out_dir = os.path.join(cfg.output_dir, "eval_output",
                                   f"Fold{cfg.cv_fold}")
            for sub, arr in (("pred", pred), ("img", sample.image[..., 0]),
                             ("gt", gt.astype(np.uint8))):
                d = os.path.join(out_dir, sub)
                os.makedirs(d, exist_ok=True)
                nifti.save(nifti.NiftiImage(arr, sample.affine),
                           os.path.join(d, name))
        scored.append((i, dice, nn, hd, {
            "name": name, "shape": tuple(pred.shape), "windows": windows,
            "predictor_calls": calls, "predict_seconds": predict_seconds,
            "hd95_seconds": hd95_seconds,
            "seconds": time.perf_counter() - t0}))

    if pdist.get_world_size() > 1:
        import torch.distributed as dist

        parts = [None] * pdist.get_world_size()
        dist.all_gather_object(parts, scored)
        scored = sorted((v for part in parts for v in part),
                        key=lambda v: v[0])
    _, all_dice, all_nn, all_hd, records = (list(c) for c in zip(*scored))
    dice_all, nn_all = np.stack(all_dice), np.stack(all_nn)
    class_dice = np.where(nn_all.sum(0) > 0,
                          dice_all.sum(0) / np.maximum(nn_all.sum(0), 1),
                          np.nan)
    hd = np.stack(all_hd)
    with np.errstate(invalid="ignore"):
        class_hd = np.nanmean(np.where(np.isfinite(hd), hd, np.nan), axis=0)
    print("Per-class Dice:", np.round(class_dice, 4).tolist())
    print("Per-class HD95:", np.round(class_hd, 2).tolist())
    print(f"Overall mDice: {np.nanmean(class_dice):.4f}  "
          f"mHD95: {np.nanmean(class_hd):.2f}")
    return {"mDice": float(np.nanmean(class_dice)),
            "mHD95": float(np.nanmean(class_hd)), "class_dice": class_dice,
            "class_hd95": class_hd, "hd95": hd, "records": records}


def main(cfg: Config) -> Dict:
    dev = pdist.init_distributed_mode(cfg, resolve_device(cfg.device))
    data_json = os.path.join(cfg.data_path, cfg.task, cfg.json_list)
    files = load_decathlon_datalist(data_json, "validation")
    ds = CachedVolumeDataset(files, cfg, cache_rate=0.0, mode="val")

    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    if cfg.resume:
        model.load_state_dict(load_checkpoint(cfg.resume), strict=True)
        print(f"Loaded checkpoint {cfg.resume}")
    model = model.to(dev).eval()

    t0 = time.perf_counter()
    with torch.inference_mode():
        result = eval_model(model, EvalLoader(ds), cfg, dev)
    print(f"Evaluation took {time.perf_counter() - t0:.1f}s for {len(ds)} "
          "volumes")
    return result


if __name__ == "__main__":
    args = get_args()
    if args.output_dir:
        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    try:
        main(args)
    finally:
        pdist.shutdown()
