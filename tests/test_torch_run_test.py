"""The port's prediction CLI against the JAX CLI, and the port's import rule.

A tiny synthetic Decathlon dataset (two anisotropic test volumes, resampled
to 1 mm, so the spacing and the ``rs`` restore paths run) goes through the
JAX ``cli.run_test.main`` and the port's with ``--device cpu`` on the same
weights; the ``pred`` NIfTIs must agree voxel for voxel to 99.9 %.
"""

import glob
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from medicalsemseg_tpu.data import nifti

from medicalsemseg_tpu_torch.cli import run_test as port_cli
from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

from tests.test_torch_model import jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a two-stage flagship at roi 16: the point here is the CLI around it
ARGV = ["--model", "nnFormerUNETR", "--vol_size", "16", "--patch_size", "2",
        "--hidden_dim", "12", "--depths", "1", "1", "--num_heads", "2", "2",
        "--window_size", "2",
        "--output_dim", "3", "--compute_dtype", "float32", "--qkv_bias",
        "--t_fixed_ct_intensity", "--t_ct_min", "-200", "--t_ct_max", "300",
        "--t_voxel_spacings", "--batch_size_val", "2",
        "--save_eval_output", "--task", "Task99_Tiny"]


def _write_test_set(root):
    task = root / "Task99_Tiny"
    (task / "imagesTs").mkdir(parents=True)
    rng = np.random.default_rng(0)
    test = []
    for i, shape in enumerate(((20, 22, 16), (18, 24, 15))):
        img = rng.normal(40, 120, size=shape).astype(np.float32)
        img[4:12, 5:15, 3:10] += 250.0  # a bright organ-like block
        aff = np.diag([1.5, 1.5, 2.0, 1.0])
        aff[:3, 3] = (-10.0, 5.0, 3.0)
        nifti.save(nifti.NiftiImage(img, aff),
                   str(task / "imagesTs" / f"img{i}.nii.gz"))
        test.append(f"./imagesTs/img{i}.nii.gz")
    with open(task / "dataset.json", "w") as f:
        json.dump({"training": [], "test": test}, f)


def test_preds_match_jax_cli(tmp_path, monkeypatch):
    import jax
    from medicalsemseg_tpu.cli import run_test as jax_cli
    from medicalsemseg_tpu.config import get_args

    _write_test_set(tmp_path)
    argv = ARGV + ["--data_path", str(tmp_path)]
    cfg_j = get_args(argv + ["--output_dir", str(tmp_path / "jax")])
    cfg_t = port_cli.get_args(
        argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu",
                "--resume", str(tmp_path / "w.pth")])
    assert cfg_t.device == "cpu"

    _, params = jax_params(cfg_j, seed=3)
    torch.save({"model": state_dict_from_jax(params)}, tmp_path / "w.pth")
    # the JAX CLI on these weights, on one device (its multi-device path
    # predicts the same logits per volume, bit for bit)
    state = types.SimpleNamespace(params=params, batch_stats={})
    monkeypatch.setattr(jax_cli, "create_train_state",
                        lambda *a, **k: (state, None))
    real_devices = jax.local_devices
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: real_devices()[:1])
    jax_cli.main(cfg_j)

    records = port_cli.main(cfg_t)
    assert [r["predictor_calls"] for r in records] == [
        -(-r["windows"] // 2) for r in records]

    for sub in ("pred", "img", "rs"):
        want = sorted(glob.glob(str(tmp_path / "jax" / "test_output" / "Fold0"
                                    / sub / "*")))
        got = sorted(glob.glob(str(tmp_path / "port" / "test_output" / "Fold0"
                                   / sub / "*")))
        assert [os.path.basename(p) for p in got] == [
            os.path.basename(p) for p in want] and len(got) == 2
        for g, w in zip(got, want):
            gi, wi = nifti.load(g), nifti.load(w)
            assert gi.data.shape == wi.data.shape
            np.testing.assert_array_equal(gi.affine, wi.affine)
            if sub == "img":
                np.testing.assert_array_equal(gi.data, wi.data)
            else:
                assert gi.data.dtype == np.uint8
                assert (gi.data == wi.data).mean() >= 0.999, (sub, g)
    rs = nifti.load(sorted(glob.glob(str(tmp_path / "port" / "test_output"
                                         / "Fold0" / "rs" / "*")))[0])
    assert rs.data.shape == (20, 22, 16)


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = port_cli.get_args(ARGV + ["--data_path", str(tmp_path)])
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.main(cfg)


@pytest.mark.parametrize("policy", ["bucket", "sorted_max"])
def test_two_ranks_write_the_files_of_one(tmp_path, policy):
    """``torchrun --nproc_per_node 2``: each rank predicts one of the two
    volumes whole and writes its files; together they are the one-process
    run's files, voxel for voxel (both runs two CPU threads a rank). Under
    ``sorted_max`` both volumes are padded to their group's maximum, as
    the JAX package's 2-device run pads them."""
    from tests.test_torch_dist import torchrun

    _write_test_set(tmp_path)
    _, params = jax_params(port_cli.get_args(ARGV), seed=3)
    torch.save({"model": state_dict_from_jax(params)}, tmp_path / "w.pth")
    argv = ARGV + ["--data_path", str(tmp_path), "--device", "cpu",
                   "--resume", str(tmp_path / "w.pth"), "--val_group_policy",
                   policy]
    outs = {}
    for n in (1, 2):
        text = torchrun("medicalsemseg_tpu_torch.cli.run_test",
                        argv + ["--output_dir", str(tmp_path / f"w{n}")], n)
        assert f"process {n - 1} of {n}" in text
        outs[n] = sorted(glob.glob(str(tmp_path / f"w{n}" / "test_output"
                                       / "Fold0" / "*" / "*")))
    assert [os.path.relpath(p, tmp_path / "w2") for p in outs[2]] == [
        os.path.relpath(p, tmp_path / "w1") for p in outs[1]]
    assert len(outs[1]) == 6
    for a, b in zip(outs[1], outs[2]):
        ia, ib = nifti.load(a), nifti.load(b)
        np.testing.assert_array_equal(ia.data, ib.data)
        np.testing.assert_array_equal(ia.affine, ib.affine)


def test_port_imports_no_jax():
    """After importing every module of the port (and chip_smoke.py), no jax
    package and nothing of the JAX package ``medicalsemseg_tpu`` is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import medicalsemseg_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert len(names) > 25, names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'medicalsemseg_tpu'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
