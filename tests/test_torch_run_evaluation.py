"""The port's labelled evaluation and fold majority-vote CLIs against the
JAX CLIs, on the CPU.

A tiny synthetic Decathlon set (two anisotropic labelled volumes, resampled
to 1 mm) goes through the JAX ``cli.run_evaluation.main`` and the port's
with ``--device cpu`` on the same weights (a two-stage flagship, carried by
``state_dict_from_jax``), with ``--save_eval_output``:
``eval_output/Fold0/{pred,img,gt}`` have the same names, shapes and affines,
img and gt are bit-equal and pred agrees on >= 99.9 % of the voxels (the
tolerance of ``tests/test_torch_run_test.py``: fp32 sums in another order
may flip a near-tied argmax); the per-class Dice agree within 1e-3 (the JAX
CLI prints them to 4 decimals); HD95 recomputed on the JAX prediction by
both functions is equal. Then ``cli.majority_vote.main`` over three copies
of the fold predictions, one of them altered, writes the same NIfTI bytes
as the JAX CLI.
"""

import glob
import gzip
import json
import os
import re
import shutil
import types

import numpy as np
import pytest

from medicalsemseg_tpu.data import nifti

from medicalsemseg_tpu_torch.cli import majority_vote as port_vote
from medicalsemseg_tpu_torch.cli import run_evaluation as port_cli
from medicalsemseg_tpu_torch.train import metrics as port_metrics
from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

from tests.test_torch_model import jax_params

ARGV = ["--model", "nnFormerUNETR", "--vol_size", "16", "--patch_size", "2",
        "--hidden_dim", "12", "--depths", "1", "1", "--num_heads", "2", "2",
        "--window_size", "2",
        "--output_dim", "3", "--compute_dtype", "float32", "--qkv_bias",
        "--t_fixed_ct_intensity", "--t_ct_min", "-200", "--t_ct_max", "300",
        "--t_voxel_spacings", "--batch_size_val", "2",
        "--save_eval_output", "--task", "Task98_TinyEval"]


def _write_eval_set(root):
    task = root / "Task98_TinyEval"
    (task / "imagesTr").mkdir(parents=True)
    (task / "labelsTr").mkdir()
    rng = np.random.default_rng(1)
    val = []
    for i, shape in enumerate(((20, 22, 16), (18, 24, 15))):
        img = rng.normal(40, 120, size=shape).astype(np.float32)
        lab = np.zeros(shape, np.uint8)
        img[4:12, 5:15, 3:10] += 250.0
        lab[4:12, 5:15, 3:10] = 1
        img[13:17, 3:9, 9:14] -= 150.0
        lab[13:17, 3:9, 9:14] = 2
        aff = np.diag([1.5, 1.5, 2.0, 1.0])
        aff[:3, 3] = (-10.0, 5.0, 3.0)
        nifti.save(nifti.NiftiImage(img, aff),
                   str(task / "imagesTr" / f"img{i}.nii.gz"))
        nifti.save(nifti.NiftiImage(lab, aff),
                   str(task / "labelsTr" / f"img{i}.nii.gz"))
        val.append({"image": f"./imagesTr/img{i}.nii.gz",
                    "label": f"./labelsTr/img{i}.nii.gz"})
    with open(task / "dataset.json", "w") as f:
        json.dump({"training": [], "validation": val}, f)


def _files(root, sub):
    return sorted(glob.glob(str(root / "eval_output" / "Fold0" / sub / "*")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs on the same set and weights: (root, port result, JAX
    per-class Dice as printed)."""
    import contextlib
    import io

    import jax
    from medicalsemseg_tpu.cli import run_evaluation as jax_cli
    from medicalsemseg_tpu.config import get_args

    root = tmp_path_factory.mktemp("eval")
    _write_eval_set(root)
    argv = ARGV + ["--data_path", str(root)]
    cfg_j = get_args(argv + ["--output_dir", str(root / "jax")])
    cfg_t = port_cli.get_args(
        argv + ["--output_dir", str(root / "port"), "--device", "cpu",
                "--resume", str(root / "w.pth")])
    _, params = jax_params(cfg_j, seed=5)
    import torch

    torch.save({"model": state_dict_from_jax(params)}, root / "w.pth")
    state = types.SimpleNamespace(params=params, batch_stats={})
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_cli, "create_train_state", lambda *a, **k: (state, None))
    real_devices = jax.local_devices
    mp.setattr(jax, "local_devices", lambda *a, **k: real_devices()[:1])
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            jax_cli.main(cfg_j)
    finally:
        mp.undo()
    line = re.search(r"Per-class Dice: (\[.*\])", out.getvalue()).group(1)
    jax_dice = np.array(json.loads(line.replace("nan", "NaN")))
    result = port_cli.main(cfg_t)
    return root, result, jax_dice


def test_eval_outputs_match_jax(runs):
    root, result, _ = runs
    for sub in ("pred", "img", "gt"):
        want, got = _files(root / "jax", sub), _files(root / "port", sub)
        assert len(got) == 2 and [os.path.basename(p) for p in got] == [
            os.path.basename(p) for p in want]
        for g, w in zip(got, want):
            gi, wi = nifti.load(g), nifti.load(w)
            assert gi.data.shape == wi.data.shape
            np.testing.assert_array_equal(gi.affine, wi.affine)
            if sub == "pred":
                assert gi.data.dtype == np.uint8
                assert (gi.data == wi.data).mean() >= 0.999, g
            else:
                np.testing.assert_array_equal(gi.data, wi.data)
    # the sample's affine as it is: the translation survives (run_test
    # zeroes it)
    aff = nifti.load(_files(root / "port", "gt")[0]).affine
    assert np.abs(aff[:3, 3]).sum() > 0
    recs = result["records"]
    assert [r["predictor_calls"] for r in recs] == [
        -(-r["windows"] // 2) for r in recs]
    assert all(r["hd95_seconds"] >= 0 and r["seconds"] >= r["predict_seconds"]
               for r in recs)


def test_per_class_dice_matches_jax(runs):
    _, result, jax_dice = runs
    got = result["class_dice"]
    assert got.shape == jax_dice.shape == (3,)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(jax_dice))
    ok = ~np.isnan(got)
    assert np.abs(got[ok] - jax_dice[ok]).max() <= 1e-3
    assert result["mDice"] == pytest.approx(float(np.nanmean(got)))
    assert result["hd95"].shape == (2, 2)


def test_hd95_on_the_jax_prediction_is_equal(runs):
    from medicalsemseg_tpu.train import metrics as jax_metrics

    root, _, _ = runs
    for p, g in zip(_files(root / "jax", "pred"), _files(root / "jax", "gt")):
        pred = nifti.load(p).data.astype(np.int32)
        gt = nifti.load(g).data.astype(np.int32)
        want = jax_metrics.hausdorff95(pred, gt, 3)
        np.testing.assert_array_equal(port_metrics.hausdorff95(pred, gt, 3),
                                      want)
        np.testing.assert_array_equal(port_metrics.hausdorff95(
            pred, gt, 3, device=True, on="cpu"), want)


def test_majority_vote_cli_matches_jax(runs, tmp_path):
    from medicalsemseg_tpu.cli import majority_vote as jax_vote

    root, _, _ = runs
    preds = _files(root / "jax", "pred")
    for k in range(3):
        d = tmp_path / "folds" / f"Fold{k}" / "pred"
        d.mkdir(parents=True)
        for p in preds:
            shutil.copy(p, d / os.path.basename(p))
    # fold 2 predicts class 2 in a block: with one vote it loses, and where
    # fold 1 agrees it wins
    for k, sl in ((2, np.s_[2:9, 2:9, 2:9]), (1, np.s_[2:5, 2:5, 2:5])):
        path = tmp_path / "folds" / f"Fold{k}" / "pred" / os.path.basename(
            preds[0])
        img = nifti.load(str(path))
        data = np.array(img.data)
        data[sl] = 2
        nifti.save(nifti.NiftiImage(data, img.affine), str(path))
    argv = ["--in_folder", str(tmp_path / "folds"), "--n_classes", "3",
            "--folds", "3"]
    jax_vote.main(jax_vote.get_args(argv + ["--out_folder",
                                            str(tmp_path / "jax")]))
    port_vote.main(port_vote.get_args(argv + ["--out_folder",
                                              str(tmp_path / "port")]))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 2
    for name in names:
        with gzip.open(tmp_path / "jax" / name) as f:
            want = f.read()
        with gzip.open(tmp_path / "port" / name) as f:
            assert f.read() == want, name
    vote = nifti.load(str(tmp_path / "port" / names[0])).data
    assert (vote[2:5, 2:5, 2:5] == 2).all()


def test_vote_cli_checks_fold_counts(tmp_path):
    for k, n in ((0, 2), (1, 1)):
        d = tmp_path / f"Fold{k}" / "pred"
        d.mkdir(parents=True)
        for i in range(n):
            nifti.save(nifti.NiftiImage(np.zeros((2, 2, 2), np.uint8),
                                        np.eye(4)), str(d / f"{i}.nii.gz"))
    args = port_vote.get_args(["--in_folder", str(tmp_path), "--n_classes",
                               "2", "--folds", "2"])
    with pytest.raises(ValueError, match="Fold1 has 1 volumes"):
        port_vote.main(args)
    args.folds = 3
    with pytest.raises(FileNotFoundError):
        port_vote.main(args)


_EVAL_RANKS = """
    import json, os, sys
    import numpy as np
    from medicalsemseg_tpu_torch.cli import run_evaluation as cli

    res = cli.main(cli.get_args(sys.argv[1:]))
    if int(os.environ["RANK"]) == 0:
        json.dump({k: np.asarray(res[k]).tolist() for k in
                   ("mDice", "mHD95", "class_dice", "class_hd95", "hd95")}
                  | {"names": [r["name"] for r in res["records"]]},
                  open(os.path.join(os.environ["OUT"],
                                    f"eval{os.environ['WORLD_SIZE']}.json"),
                       "w"))
"""


def test_two_ranks_score_as_one(tmp_path):
    """Two gloo ranks score a volume each and gather the per-volume Dice
    and HD95 in the datalist's order: mDice and mHD95 (and the per-class
    lists) within 1e-6 of one process's, every rank two CPU threads."""
    from tests.test_torch_dist import run_ranks

    _write_eval_set(tmp_path)
    _, params = jax_params(port_cli.get_args(ARGV), seed=5)
    import torch

    torch.save({"model": state_dict_from_jax(params)}, tmp_path / "w.pth")
    argv = ARGV + ["--data_path", str(tmp_path), "--device", "cpu",
                   "--resume", str(tmp_path / "w.pth"), "--output_dir",
                   str(tmp_path / "out")]
    for n in (1, 2):
        run_ranks(_EVAL_RANKS, n, tmp_path, argv=argv)
    one, two = (json.loads((tmp_path / f"eval{n}.json").read_text())
                for n in (1, 2))
    assert two["names"] == one["names"] and len(one["names"]) == 2
    for k in ("mDice", "mHD95", "class_dice", "class_hd95", "hd95"):
        np.testing.assert_allclose(two[k], one[k], rtol=0, atol=1e-6,
                                   err_msg=k)
