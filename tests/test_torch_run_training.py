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


def train_and_resume(tmp_path, model_args):
    """One epoch of a zoo model through the CLI (2 steps), then a resume
    for a second: finite losses, the checkpoint's BatchNorm running
    statistics (where the model has any) moved off their start, and the
    resumed run continues with epoch 1 and the optimizer's third update."""
    _write_train_set(tmp_path)
    out = str(tmp_path / "out")
    os.makedirs(out)
    argv = ARGV + model_args + ["--data_path", str(tmp_path), "--output_dir",
                                out, "--log_dir", str(tmp_path / "log")]
    cli.main(get_args(argv + ["--epochs", "1"]))
    first = torch.load(os.path.join(out, "checkpoint-0.pth"),
                       weights_only=True)
    assert first["step"] == first["updates"] == 2
    for key, v in first["model"].items():
        if key.endswith("running_var"):
            assert not torch.allclose(v, torch.ones_like(v)), key
    cli.main(get_args(argv + ["--epochs", "2", "--resume",
                              os.path.join(out, "checkpoint-0.pth")]))
    log = _log(out)
    assert [r["epoch"] for r in log] == [0, 1]
    assert all(np.isfinite(r["train/loss"]) for r in log)
    second = torch.load(os.path.join(out, "checkpoint-1.pth"),
                        weights_only=True)
    assert second["epoch"] == 1 and second["step"] == second["updates"] == 4
    return first, second


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


# the id the case had while the CLI refused the flag, kept
@pytest.mark.parametrize("flag", [["--remat", "full"]],
                         ids=["flag3-rematerialisation"])
def test_unported_flags_raise(tmp_path, flag):
    """``--remat full``, refused until the port had block rematerialisation:
    an epoch of two steps at drop path 0.2 through the CLI writes the same
    checkpoint, bit for bit, as ``--remat none``."""
    _write_train_set(tmp_path)
    saved = []
    for remat in (["--remat", "none"], flag):
        out = str(tmp_path / remat[1])
        os.makedirs(out)
        cli.main(get_args(ARGV + remat + [
            "--data_path", str(tmp_path), "--output_dir", out, "--epochs",
            "1", "--val_interval", "5", "--drop_path_rate", "0.2"]))
        saved.append(torch.load(os.path.join(out, "checkpoint-0.pth"),
                                weights_only=True))
    assert saved[0]["updates"] == saved[1]["updates"] == 2
    for k, v in saved[0]["model"].items():
        assert torch.equal(saved[1]["model"][k], v), k
    assert torch.equal(saved[1]["generator"], saved[0]["generator"])


def test_world_size_without_a_launcher_names_torchrun(tmp_path):
    """One process cannot be two: ``--world_size 2`` outside a launcher
    says how to start the port on two GPUs."""
    _write_train_set(tmp_path)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        cli.main(get_args(ARGV + ["--world_size", "2", "--data_path",
                                  str(tmp_path)]))


def test_device_data_pipeline_epoch(tmp_path):
    """``--device_data_pipeline``: the volumes cached as tensors, the crops
    cut and augmented by tensor ops (here on the CPU): an epoch of two
    steps trains, validates and writes its checkpoint."""
    _write_train_set(tmp_path)
    out = str(tmp_path / "out")
    os.makedirs(out)
    cli.main(get_args(ARGV + ["--device_data_pipeline", "--t_rot_prob", "0.5",
                              "--data_path", str(tmp_path), "--output_dir",
                              out, "--epochs", "1"]))
    (rec,) = _log(out)
    assert np.isfinite(rec["train/loss"]) and np.isfinite(rec["val/loss"])
    payload = torch.load(os.path.join(out, "checkpoint-0.pth"),
                         weights_only=True)
    assert payload["step"] == payload["updates"] == 2


def test_two_ranks_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node 2`` on gloo: the batch of 2 volumes is
    split one a rank, an epoch keeps the one-process run's 2 steps (so 2
    updates), both ranks validate, and rank 0 alone writes the log lines,
    scalars, metrics and checkpoints."""
    from tests.test_torch_dist import torchrun

    _write_train_set(tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    text = torchrun("medicalsemseg_tpu_torch.cli.run_training", ARGV + [
        "--data_path", str(tmp_path), "--output_dir", str(out), "--log_dir",
        str(tmp_path / "log"), "--epochs", "2"], 2)
    assert "rank 0: 2 train / 2 val volumes, 1 x 1 crops a step" in text
    assert "rank 1: 2 train / 2 val volumes, 1 x 1 crops a step" in text
    log = _log(str(out))
    assert [r["epoch"] for r in log] == [0, 1]
    assert all(np.isfinite(r["train/loss"]) and np.isfinite(r["val/loss"])
               for r in log)
    payload = torch.load(out / "checkpoint-1.pth", weights_only=True)
    assert payload["step"] == payload["updates"] == 4
    assert not any(k.startswith("module.") for k in payload["model"])
    metrics = [json.loads(line) for line in
               open(tmp_path / "log" / "metrics.jsonl")]
    assert [m.get("epoch") for m in metrics[1:]] == [0, 1]
    scalars = [json.loads(line) for line in
               open(tmp_path / "log" / "scalars.jsonl")]
    assert [s["tag"] for s in scalars].count("val_loss") == 2


def test_a_rank_sits_out_a_batch_of_one(tmp_path):
    """A global batch of one crop on two ranks: dp is 1, rank 1 sits out
    the steps (no train files), takes rank 0's weights and validates its
    share of the volumes."""
    from tests.test_torch_dist import torchrun

    _write_train_set(tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    text = torchrun("medicalsemseg_tpu_torch.cli.run_training", ARGV + [
        "--n_images_per_batch", "1", "--data_path", str(tmp_path),
        "--output_dir", str(out), "--epochs", "1"], 2)
    assert "batch 1 not divisible by 2 ranks; using 1-way" in text
    assert "rank 1: 0 train / 2 val volumes" in text
    (rec,) = _log(str(out))
    assert np.isfinite(rec["train/loss"]) and np.isfinite(rec["val/loss"])
    payload = torch.load(out / "checkpoint-0.pth", weights_only=True)
    assert payload["step"] == payload["updates"] == 4


def test_fused_loss_run_then_pretrained_run(tmp_path, monkeypatch):
    """One epoch with ``--fused_loss`` and accumulation (K8's plain version on
    the CPU; validation's masked loss stays unfused), then a fresh run with
    ``--pretrained`` on the file it wrote: the encoder starts from the
    file's weights, the decoder from its own initialisation."""
    from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8
    from medicalsemseg_tpu_torch.utils import params as pparams

    _write_train_set(tmp_path)
    out = str(tmp_path / "out")
    os.makedirs(out)
    calls = []
    real = k8.dice_ce_sums
    monkeypatch.setattr(k8, "dice_ce_sums",
                        lambda lg, lb: calls.append(lg.shape) or real(lg, lb))
    argv = ARGV + ["--data_path", str(tmp_path), "--output_dir", out,
                   "--epochs", "1", "--fused_loss"]
    cli.main(get_args(argv + ["--grad_accum_steps", "2"]))
    # 4 train volumes at batch 2: two micro-steps, one update; validation
    # (2 volumes, masked loss) never reaches the fused function
    assert [tuple(s) for s in calls] == [(2, 16 ** 3, 3)] * 2
    first = os.path.join(out, "checkpoint-0.pth")
    payload = torch.load(first, weights_only=True)
    assert payload["step"] == 2 and payload["updates"] == 1
    log = _log(out)
    assert np.isfinite(log[0]["train/loss"]) and np.isfinite(log[0]["val/loss"])

    loaded = {}
    real_load = pparams.load_pretrained_encoder
    monkeypatch.setattr(cli, "load_pretrained_encoder", lambda model, *a: (
        loaded.update(keys=real_load(model, *a),
                      sd={k: v.clone() for k, v in model.state_dict().items()})
        or loaded["keys"]))
    out2 = str(tmp_path / "out2")
    os.makedirs(out2)
    cli.main(get_args(ARGV + ["--data_path", str(tmp_path), "--output_dir",
                              out2, "--epochs", "1", "--seed", "5",
                              "--pretrained", first]))
    want = payload["model"]
    enc = [k for k in want if k.startswith("encoder.")]
    assert loaded["keys"] == sorted(enc) and len(enc) > 20
    for k in enc:      # right after the load: the file's encoder, bit for bit
        assert torch.equal(loaded["sd"][k], want[k]), k
    dec = [k for k in want if not k.startswith("encoder.")]
    assert any(not torch.equal(loaded["sd"][k], want[k]) for k in dec)
    assert os.path.exists(os.path.join(out2, "checkpoint-0.pth"))


def test_pretrained_table_from_another_window_is_resized(tmp_path):
    """A checkpoint trained with window 3 loads into a window-2 model: its
    (2*3-1)^3-row bias tables are resized as the JAX package's
    ``resize_rel_pos_bias_table`` resizes them; other tensors load as they
    are; a file that lacks an encoder key is refused."""
    from medicalsemseg_tpu.utils.torch_import import resize_rel_pos_bias_table

    from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
    from medicalsemseg_tpu_torch.utils.params import (
        load_pretrained_encoder, resize_rel_pos_bias_table as port_resize)

    def model_for(window):
        argv = [a for a in ARGV]
        argv[argv.index("--window_size") + 1] = str(window)
        cfg = get_args(argv)
        return cfg, init_weights(build_model(cfg),
                                 torch.Generator().manual_seed(window))

    _, src = model_for(3)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in src.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_(0.0, 0.5, generator=gen)
    path = str(tmp_path / "w3.pth")
    torch.save({"model": {"module." + k: v for k, v in
                          src.state_dict().items()}}, path)
    _, dst = model_for(2)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    keys = load_pretrained_encoder(dst, path)
    after, want = dst.state_dict(), src.state_dict()
    tables = [k for k in keys if k.endswith("relative_position_bias_table")]
    assert len(tables) == 2
    for k in keys:
        if k in tables:
            assert want[k].shape[0] == 125 and after[k].shape[0] == 27
            ref = resize_rel_pos_bias_table(want[k].numpy(), 3, 2)
            np.testing.assert_allclose(after[k].numpy(), ref, rtol=0, atol=0)
            np.testing.assert_array_equal(
                port_resize(want[k].numpy(), (3, 3, 3), (2, 2, 2)), ref)
        else:
            assert torch.equal(after[k], want[k]), k
    for k in after:
        if not k.startswith("encoder."):
            assert torch.equal(after[k], before[k]), k
    # same window: the table is taken as it is
    assert port_resize(want[tables[0]].numpy(), 3, 3).shape == (125, 2)

    sd = dict(src.state_dict())
    del sd["encoder.patch_embed.proj.weight"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="patch_embed.proj.weight"):
        load_pretrained_encoder(dst, path)


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = get_args([a for a in ARGV if a not in ("--device", "cpu")])
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(cfg)
