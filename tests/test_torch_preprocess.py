"""The port's jax-free preprocessing against the JAX package's.

``medicalsemseg_tpu_torch.data.preprocess.load_and_preprocess`` in its val
and test modes against ``medicalsemseg_tpu.data.transforms`` on the same
NIfTI files, and the spacing resample against ``ops.resize``. NumPy on both
sides in the same order, so the arrays agree to fp32 rounding.
"""

import numpy as np
import pytest

from medicalsemseg_tpu.config import Config
from medicalsemseg_tpu.data import nifti
from medicalsemseg_tpu.data.transforms import load_and_preprocess as jax_lp
from medicalsemseg_tpu.ops.resize import spacing_resample_np as jax_resample

from medicalsemseg_tpu_torch.data import preprocess as pp


def _files(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.normal(30, 200, size=(22, 18, 14)).astype(np.float32)
    img[:3] = -1000.0  # air slab: crop-foreground has something to cut
    lab = np.zeros(img.shape, np.uint8)
    lab[8:14, 6:12, 4:9] = 2
    # flipped, anisotropic axes: reorientation and spacing both act
    aff = np.diag([-1.5, 1.0, 2.0, 1.0])
    aff[:3, 3] = (20.0, -5.0, 7.0)
    nifti.save(nifti.NiftiImage(img, aff), str(tmp_path / "img0.nii.gz"))
    nifti.save(nifti.NiftiImage(lab, aff), str(tmp_path / "lab0.nii.gz"))
    return str(tmp_path / "img0.nii.gz"), str(tmp_path / "lab0.nii.gz")


@pytest.mark.parametrize("mode,flags", [
    ("test", dict(t_fixed_ct_intensity=True, t_voxel_spacings=True)),
    ("test", dict(t_cubed_ct_intensity=True, t_normalize=True)),
    ("val", dict(t_fixed_ct_intensity=True, t_crop_foreground_img=True,
                 t_spatial_pad=True, t_normalize=True, vol_size=24,
                 t_voxel_spacings=True, t_voxel_dims=(1.0, 1.25, 1.5))),
    ("val", dict(t_percentile_ct_intensity=True,
                 t_normalize=True, t_normalize_channel_wise=True)),
])
def test_matches_jax_pipeline(tmp_path, mode, flags):
    img_path, lab_path = _files(tmp_path)
    cfg = Config(**flags)
    label = lab_path if mode == "val" else None
    want = jax_lp(img_path, label, cfg, mode=mode)
    got = pp.load_and_preprocess(img_path, label, cfg, mode=mode)
    np.testing.assert_allclose(got.image, want.image, rtol=1e-6, atol=1e-6)
    if label is not None:
        np.testing.assert_array_equal(got.label, want.label)
    np.testing.assert_allclose(got.affine, want.affine)
    np.testing.assert_array_equal(got.original_affine, want.original_affine)
    assert tuple(got.original_shape) == tuple(want.original_shape)


def test_spacing_resample_matches_jax():
    rng = np.random.default_rng(5)
    vol = rng.normal(size=(10, 12, 7, 2)).astype(np.float32)
    aff = np.diag([0.8, 1.2, 2.5, 1.0])
    for mode in ("trilinear", "nearest"):
        got, gaff = pp.spacing_resample_np(vol, aff, (1.0, 1.0, 1.0), mode)
        want, waff = jax_resample(vol, aff, (1.0, 1.0, 1.0), mode)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(gaff, waff)


def test_training_mode_is_not_ported(tmp_path):
    """Kept under the name it had while ``mode="train"`` still raised; the
    mode is ported now (``tests/test_torch_train_data.py`` holds its crops
    against the JAX package)."""
    img_path, lab_path = _files(tmp_path)
    got = pp.load_and_preprocess(img_path, lab_path, Config(), mode="train")
    assert got.label is not None and got.image.shape[:3] == got.label.shape[:3]


def test_unknown_mode_raises(tmp_path):
    img_path, lab_path = _files(tmp_path)
    with pytest.raises(ValueError, match="expected train, val or test"):
        pp.load_and_preprocess(img_path, lab_path, Config(), mode="predict")
