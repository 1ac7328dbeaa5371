"""The port's training data path against the JAX package's.

``load_and_preprocess(mode="train")``, ``sample_training_crops`` and
``TrainLoader`` draw from ``np.random.Generator`` in the same order as
``medicalsemseg_tpu.data.{transforms,dataset}``, so the same seed must give
bit-equal crops and batches.
"""

import numpy as np
import pytest

from medicalsemseg_tpu.config import Config
from medicalsemseg_tpu.data import dataset as jax_ds
from medicalsemseg_tpu.data import nifti
from medicalsemseg_tpu.data import transforms as jax_tf

from medicalsemseg_tpu_torch.data import dataset as port_ds
from medicalsemseg_tpu_torch.data import preprocess as pp


def _volume(rng, shape):
    img = rng.normal(60, 150, size=shape).astype(np.float32)
    img[:2] = -1000.0
    lab = np.zeros(shape, np.uint8)
    lab[6:12, 5:11, 4:9] = 1
    lab[14:19, 3:8, 8:12] = 2
    return img, lab


def _write(tmp_path, n):
    rng = np.random.default_rng(11)
    files = []
    for i in range(n):
        img, lab = _volume(rng, (24 + 2 * i, 20, 16 + i))
        aff = np.diag([-1.2, 1.0, 1.6, 1.0])
        ip, lp = tmp_path / f"img{i}.nii.gz", tmp_path / f"lab{i}.nii.gz"
        nifti.save(nifti.NiftiImage(img, aff), str(ip))
        nifti.save(nifti.NiftiImage(lab, aff), str(lp))
        files.append({"image": str(ip), "label": str(lp)})
    return files


AUG = dict(t_flip_prob=0.5, t_rot_prob=0.5, t_intensity_shift_prob=0.5,
           t_intensity_scale_prob=0.5, t_normalize=True)
CASES = {
    "fgbg": dict(t_rand_crop_fgbg=True, t_n_patches_per_image=3, **AUG),
    "classes": dict(t_rand_crop_classes=True, t_rand_crop_pos_weight=2.0,
                    t_n_patches_per_image=2, **AUG),
    "dilated": dict(t_rand_crop_dilated_center=True, t_n_patches_per_image=2,
                    t_flip_prob=0.3),
    "spatial": dict(t_rand_spatial_crop=True, t_n_patches_per_image=2,
                    t_normalize=True, t_normalize_channel_wise=True, **{
                        k: v for k, v in AUG.items() if k != "t_normalize"}),
    "center_kdiv": dict(t_crop_foreground_kdiv=True, t_spatial_pad=True),
}


def _cfg(**kw):
    base = dict(vol_size=12, output_dim=3, t_fixed_ct_intensity=True,
                t_crop_foreground_img=True, n_images_per_batch=2,
                n_workers_train=2)
    base.update(kw)
    return Config(**base)


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_crops_are_bit_equal(tmp_path, case):
    cfg = _cfg(**CASES[case])
    f = _write(tmp_path, 1)[0]
    want_s = jax_tf.load_and_preprocess(f["image"], f["label"], cfg, "train")
    got_s = pp.load_and_preprocess(f["image"], f["label"], cfg, "train")
    np.testing.assert_array_equal(got_s.image, want_s.image)
    np.testing.assert_array_equal(got_s.label, want_s.label)
    if want_s.crop_mask is None:
        assert got_s.crop_mask is None
    else:
        np.testing.assert_array_equal(got_s.crop_mask, want_s.crop_mask)
    for seed in (0, 1):
        want = jax_tf.sample_training_crops(want_s, cfg,
                                            np.random.default_rng(seed))
        got = pp.sample_training_crops(got_s, cfg, np.random.default_rng(seed))
        assert len(got) == len(want) == cfg.t_n_patches_per_image
        for g, w in zip(got, want):
            _assert_same(g, w)
            assert g["image"].shape == (12, 12, 12, 1)


def test_train_loader_batches_are_bit_equal(tmp_path):
    cfg = _cfg(**CASES["fgbg"])
    files = _write(tmp_path, 5)
    want_l = jax_ds.TrainLoader(
        jax_ds.CachedVolumeDataset(files, cfg, mode="train"), cfg, seed=7)
    got_l = port_ds.TrainLoader(
        port_ds.CachedVolumeDataset(files, cfg, mode="train"), cfg, seed=7)
    assert got_l.steps_per_epoch() == want_l.steps_per_epoch() == 2
    for epoch in (0, 3):
        got, want = list(got_l.epoch(epoch)), list(want_l.epoch(epoch))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _assert_same(g, w)
            assert g["image"].shape == (6, 12, 12, 12, 1)
            assert g["label"].shape == (6, 12, 12, 12)
            assert g["crop_loc"].shape == g["affine"].shape == (6, 3)


def test_tiny_dataset_wraps_to_a_full_batch(tmp_path):
    cfg = _cfg(n_images_per_batch=3, **CASES["spatial"])
    files = _write(tmp_path, 2)
    want = next(iter(jax_ds.TrainLoader(
        jax_ds.CachedVolumeDataset(files, cfg, mode="train"), cfg,
        seed=1).epoch(0)))
    got = next(iter(port_ds.TrainLoader(
        port_ds.CachedVolumeDataset(files, cfg, mode="train"), cfg,
        seed=1).epoch(0)))
    _assert_same(got, want)
    assert got["image"].shape[0] == 3 * cfg.t_n_patches_per_image
