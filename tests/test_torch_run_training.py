"""The port's training CLI on a tiny synthetic Decathlon folder on the CPU:
epochs of a few steps, sliding-window validation, best and periodic
checkpoints, log files, clean-up, and a resume that starts where the first
run ended. A two-stage flagship at roi 16 in fp32; the kernels run as their
plain versions through the autograd functions."""

import json
import os

import numpy as np
import pytest
import torch

from medicalsemseg_tpu.data import nifti

from medicalsemseg_tpu_torch.cli import run_training as cli
from medicalsemseg_tpu_torch.config import get_args

ARGV = ["--model", "nnFormerUNETR", "--vol_size", "16", "--patch_size", "2",
        "--hidden_dim", "12", "--depths", "1", "1", "--num_heads", "2", "2",
        "--window_size", "2", "--output_dim", "3", "--compute_dtype",
        "float32", "--t_fixed_ct_intensity", "--t_ct_min", "-200",
        "--t_ct_max", "300", "--t_rand_crop_fgbg", "--t_flip_prob", "0.5",
        "--t_spatial_pad", "--n_images_per_batch", "2", "--n_workers_train",
        "2", "--sw_batch_size", "4",
        "--warmup_epochs", "0", "--lr", "1e-3", "--gradient_clipping", "1.0",
        "--val_interval", "1", "--save_ckpt_freq", "1",
        "--metric_readback_freq", "2", "--cv_max_folds", "3",
        "--task", "Task98_TinyTrain", "--device", "cpu"]


def _write_train_set(root, n=6):
    task = root / "Task98_TinyTrain"
    (task / "imagesTr").mkdir(parents=True)
    (task / "labelsTr").mkdir()
    rng = np.random.default_rng(0)
    training = []
    for i in range(n):
        shape = (20 + i, 18, 17)
        img = rng.normal(40, 60, size=shape).astype(np.float32)
        lab = np.zeros(shape, np.uint8)
        lab[4:10, 5:12, 3:9] = 1
        lab[11:16, 8:15, 9:14] = 2
        img[lab == 1] += 150.0
        img[lab == 2] -= 120.0
        aff = np.diag([1.0, 1.0, 1.5, 1.0])
        nifti.save(nifti.NiftiImage(img, aff),
                   str(task / "imagesTr" / f"img{i}.nii.gz"))
        nifti.save(nifti.NiftiImage(lab, aff),
                   str(task / "labelsTr" / f"img{i}.nii.gz"))
        training.append({"image": f"./imagesTr/img{i}.nii.gz",
                         "label": f"./labelsTr/img{i}.nii.gz"})
    with open(task / "dataset.json", "w") as f:
        json.dump({"training": training, "test": []}, f)


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def test_train_validate_checkpoint_and_resume(tmp_path):
    _write_train_set(tmp_path)
    out = str(tmp_path / "out")
    os.makedirs(out)
    argv = ARGV + ["--data_path", str(tmp_path), "--output_dir", out,
                   "--log_dir", str(tmp_path / "log")]
    result = cli.main(get_args(argv + ["--epochs", "2"]))
    assert set(result) == {"best_val_metric", "best_epoch"}

    log = _log(out)
    assert [r["epoch"] for r in log] == [0, 1]
    keys = {"train/loss", "train/lr", "train/mDice", "val/loss", "val/mDice",
            "epoch"}
    for r in log:
        assert keys <= set(r), sorted(r)
        assert np.isfinite(r["train/loss"]) and np.isfinite(r["val/loss"])
        assert r["train/lr"] > 0
    # periodic checkpoints are cleaned up to the newest; the best one stays
    # when validation found any foreground at all
    files = sorted(f for f in os.listdir(out) if f.endswith(".pth"))
    assert "checkpoint-1.pth" in files and "checkpoint-0.pth" not in files
    assert set(files) <= {"checkpoint-1.pth", "best_model.pth"}
    payload = torch.load(os.path.join(out, "checkpoint-1.pth"),
                         weights_only=True)
    # 6 volumes, fold 0 of 3 holds 2 out: 4 train volumes, 2 steps per epoch
    assert payload["epoch"] == 1 and payload["step"] == payload["updates"] == 4
    scalars = [json.loads(line) for line in
               open(tmp_path / "log" / "scalars.jsonl")]
    assert {"train_loss", "lr", "val_loss", "val_mDice"} <= {
        s["tag"] for s in scalars}
    metrics = [json.loads(line) for line in
               open(tmp_path / "log" / "metrics.jsonl")]
    assert "tags" in metrics[0] and metrics[-1]["epoch"] == 1

    # resume: continues with epoch 2 and the optimizer's fifth update
    cli.main(get_args(argv + ["--epochs", "3", "--resume",
                              os.path.join(out, "checkpoint-1.pth")]))
    log = _log(out)
    assert [r["epoch"] for r in log] == [0, 1, 2]
    payload = torch.load(os.path.join(out, "checkpoint-2.pth"),
                         weights_only=True)
    assert payload["epoch"] == 2 and payload["step"] == 6


@pytest.mark.parametrize("flag,match", [
    (["--world_size", "2"], "multi-GPU"),
    (["--device_data_pipeline"], "device-resident"),
    (["--pretrained", "x.pth"], "backbone"),
    (["--profile_dir", "p"], "profiling"),
    (["--remat", "full"], "rematerialisation"),
])
def test_unported_flags_raise(flag, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(get_args(ARGV + flag))


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = get_args([a for a in ARGV if a not in ("--device", "cpu")])
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(cfg)
