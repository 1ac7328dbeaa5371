"""Label-free prediction (counterpart of medicalsemseg_tpu/cli/run_test.py).

    python -m medicalsemseg_tpu_torch.cli.run_test --data_path <dir> \\
        --task <Task> --resume model.pth --save_eval_output --output_dir out
    torchrun --nproc_per_node N -m medicalsemseg_tpu_torch.cli.run_test ...

Takes the flags of ``medicalsemseg_tpu_torch.config`` (the JAX package's,
plus ``--device``, default ``cuda``). Loads the test datalist, runs Gaussian
sliding-window prediction of ``--model`` (nnFormerUNETR, SwinSegFormer,
SegFormer3D or GCViTUNETR) with the hand-written kernels, with
``--tta_mirror`` averaged over the 8 flips of every window batch, argmaxes to
uint8 labels, restores the original spacing by nearest-neighbour
resampling when ``--t_voxel_spacings`` is set, and writes NIfTIs under
``test_output/Fold{k}/{pred,img,rs}``. ``--resume`` is a torch checkpoint of
the port or of the reference (``{'model': state_dict}`` or a bare one).
Under torchrun every rank predicts whole volumes of its own
(``--val_group_policy`` picks which, as in the JAX package) and writes their
files; together they write the files of a one-process run.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict, List

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
from medicalsemseg_tpu_torch.utils.params import load_checkpoint


def resample_3d_nearest(vol: np.ndarray, target_size) -> np.ndarray:
    """scipy zoom(order=0), as the JAX CLI restores spacing."""
    from scipy import ndimage

    ratios = tuple(float(t) / float(s) for t, s in zip(target_size, vol.shape))
    return ndimage.zoom(vol, ratios, order=0, prefilter=False)


def test_model(model: torch.nn.Module, loader, cfg: Config,
               device: torch.device) -> List[Dict]:
    """Predict this rank's volumes of ``loader`` (every one in a single
    process); returns one record per volume: name, shape, windows,
    predictor calls (model forwards: 8 per window batch with
    ``--tta_mirror``), seconds from the preprocessed volume to the label map
    on the host (``predict_seconds``) and to the written files
    (``seconds``)."""
    air_cval = ((0.0 - cfg.t_norm_mean) / cfg.t_norm_std
                if cfg.t_normalize else 0.0)
    records = []
    for _, sample, padded, orig in rank_volumes(
            loader, pdist.get_rank(), pdist.get_world_size(),
            cfg.sw_bucket_multiple, air_cval, cfg.val_group_policy):
        t0 = time.perf_counter()
        calls, windows = 0, 0

        def forward(model_in):
            nonlocal calls
            calls += 1
            return model(model_in)

        # with TTA the stitcher blends the mean probabilities of the flips
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
            predictor, cfg.output_dim, overlap=cfg.val_infer_overlap,
            mode="gaussian", cval=air_cval)
        logits = logits[0, :orig[0], :orig[1], :orig[2]]
        pred = logits.argmax(-1).to(torch.uint8).cpu().numpy()
        predict_seconds = time.perf_counter() - t0

        pred_rs = None
        if cfg.t_voxel_spacings:
            pred_rs = resample_3d_nearest(pred, sample.original_shape)

        img_name = os.path.basename(sample.name).split("img")[-1]
        if cfg.save_eval_output and cfg.output_dir:
            out_dir = os.path.join(cfg.output_dir, "test_output",
                                   f"Fold{cfg.cv_fold}")
            # zero translation, as the reference writes them
            affine = sample.affine.copy()
            affine[0:3, 3] = 0
            orig_affine = sample.original_affine.copy()
            orig_affine[0:3, 3] = 0
            outputs = [("pred", pred, affine),
                       ("img", sample.image[..., 0], affine)]
            if pred_rs is not None:
                outputs.append(("rs", pred_rs, orig_affine))
            for sub, arr, aff_out in outputs:
                d = os.path.join(out_dir, sub)
                os.makedirs(d, exist_ok=True)
                nifti.save(nifti.NiftiImage(arr, aff_out),
                           os.path.join(d, img_name))
        seconds = time.perf_counter() - t0
        print(f"{img_name}: predicted in {seconds:.1f}s shape {pred.shape}")
        records.append({"name": img_name, "shape": tuple(pred.shape),
                        "windows": windows, "predictor_calls": calls,
                        "predict_seconds": predict_seconds,
                        "seconds": seconds})
    return records


def main(cfg: Config) -> List[Dict]:
    dev = pdist.init_distributed_mode(cfg, resolve_device(cfg.device))
    data_json = os.path.join(cfg.data_path, cfg.task, cfg.json_list)
    files = load_decathlon_datalist(data_json, "test")
    loader = EvalLoader(CachedVolumeDataset(files, cfg, cache_rate=0.0,
                                            mode="test"))

    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    if cfg.resume:
        model.load_state_dict(load_checkpoint(cfg.resume), strict=True)
        print(f"Loaded checkpoint {cfg.resume}")
    model = model.to(dev).eval()

    t0 = time.perf_counter()
    with torch.inference_mode():
        records = test_model(model, loader, cfg, dev)
    print(f"Testing took {time.perf_counter() - t0:.1f}s for "
          f"{len(records)} volumes")
    return records


if __name__ == "__main__":
    args = get_args()
    if args.output_dir:
        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    try:
        main(args)
    finally:
        pdist.shutdown()
