"""The port's device-resident crop pipeline (``data/device_pipeline.py``)
against the JAX package's on the CPU: ``_extract_and_augment`` for every
flip pattern, rot90 k and normalisation, and ``DeviceTrainLoader``'s
batches for the same seed (the host's draws are the same generator calls
in the same order, so the crops, labels, crop locations and affines are
equal). The intensities agree to 1e-6 (XLA fuses x * scale + shift into
one rounding where PyTorch rounds twice). After ``channel`` normalisation
the port (float64 statistics) is held to 1e-6 against a float64 numpy
normalisation of the JAX loader's un-normalised crops (the draws do not
depend on the normalisation): the JAX statistics are fp32 sums over the
crop, whose rounding moved normalised values of O(1) by up to 3e-5 at
12^3 voxels, and the _extract_and_augment check (8^3 voxels) holds it to
1e-5."""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medicalsemseg_tpu.config import Config as JaxConfig
from medicalsemseg_tpu.data import device_pipeline as jdp
from medicalsemseg_tpu.data.transforms import Sample as JaxSample

from medicalsemseg_tpu_torch.config import Config
from medicalsemseg_tpu_torch.data import device_pipeline as pdp
from medicalsemseg_tpu_torch.data.preprocess import Sample

ROI = (8, 8, 8)
FLIPS = [(False, False, False), (True, False, True), (False, True, False),
         (True, True, True)]


def _volume(seed=0, shape=(20, 18, 16), c=2):
    rng = np.random.default_rng(seed)
    img = rng.normal(0.5, 1.0, size=(*shape, c)).astype(np.float32)
    img[rng.uniform(size=img.shape) < 0.2] = 0.0   # zeros for the mask
    lab = rng.integers(0, 3, size=shape).astype(np.int32)
    return img, lab


@pytest.mark.parametrize("norm", ["none", "scalar", "channel"])
@pytest.mark.parametrize("rot_k", [0, 1, 2, 3])
def test_extract_and_augment_matches_jax(norm, rot_k):
    img, lab = _volume()
    center = np.asarray([9, 7, 10])
    for flips in FLIPS:
        want_i, want_l = jdp._extract_and_augment(
            jnp.asarray(img), jnp.asarray(lab), jnp.asarray(center, jnp.int32),
            jnp.asarray(flips), jnp.asarray(rot_k, jnp.int32),
            jnp.asarray(np.float32(0.05)), jnp.asarray(np.float32(1.07)),
            jnp.asarray(np.float32(0.19)), jnp.asarray(np.float32(0.28)),
            roi=ROI, norm=norm)
        got_i, got_l = pdp._extract_and_augment(
            torch.from_numpy(img), torch.from_numpy(lab), center,
            np.asarray(flips), rot_k, float(np.float32(0.05)),
            float(np.float32(1.07)), float(np.float32(0.19)),
            float(np.float32(0.28)), roi=ROI, norm=norm)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i),
                                   rtol=0, atol=1e-5 if norm == "channel"
                                   else 1e-6, err_msg=str(flips))
        # the bare crop, flips and rot90 move values only: exact
        want_c, _ = jdp._extract_and_augment(
            jnp.asarray(img), jnp.asarray(lab), jnp.asarray(center, jnp.int32),
            jnp.asarray(flips), jnp.asarray(rot_k, jnp.int32),
            jnp.asarray(np.float32(0.0)), jnp.asarray(np.float32(1.0)),
            jnp.asarray(np.float32(0.0)), jnp.asarray(np.float32(1.0)),
            roi=ROI, norm="none")
        got_c, _ = pdp._extract_and_augment(
            torch.from_numpy(img), torch.from_numpy(lab), center,
            np.asarray(flips), rot_k, 0.0, 1.0, 0.0, 1.0, roi=ROI)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def _channel_norm64(batch):
    """Each crop's channels standardised over their nonzero voxels, in
    float64 (the normalisation of ``_extract_and_augment``)."""
    out = []
    for x in batch.astype(np.float64):
        mask = x != 0
        cnt = mask.sum((0, 1, 2))
        safe = np.maximum(cnt, 1)
        mu = np.where(mask, x, 0.0).sum((0, 1, 2)) / safe
        var = np.where(mask, (x - mu) ** 2, 0.0).sum((0, 1, 2)) / safe
        std = np.maximum(np.sqrt(var), 1e-8)
        out.append(np.where(mask & (cnt > 0), (x - mu) / std, x))
    return np.stack(out).astype(np.float32)


def _samples(cls, n=3):
    out = []
    for i in range(n):
        img, lab = _volume(seed=10 + i, shape=(18 + 3 * i, 14, 12), c=1)
        img = np.abs(img) + 0.01           # valid background everywhere
        out.append(cls(image=img, label=lab[..., None], affine=np.eye(4),
                       original_affine=np.diag([1.5, 1.25, 2.0 + i, 1.0]),
                       original_shape=img.shape[:3], name=f"v{i}"))
    return out


@pytest.mark.parametrize("normalize,channel", [(False, False), (True, False),
                                               (True, True)])
def test_device_train_loader_batches_equal_jax(normalize, channel):
    kw = dict(vol_size=12, n_images_per_batch=2, t_n_patches_per_image=2,
              t_flip_prob=0.5, t_rot_prob=0.5, t_intensity_shift_prob=0.5,
              t_intensity_scale_prob=0.5, t_rand_crop_pos_weight=2.0,
              t_normalize=normalize, t_normalize_channel_wise=channel)
    jcfg, pcfg = JaxConfig(**kw), Config(**kw)
    if channel:   # the JAX crops before the normalisation
        jcfg = jcfg.replace(t_normalize=False)
    jload = jdp.DeviceTrainLoader(
        jdp.DeviceCachedDataset(_samples(JaxSample), jcfg), jcfg, seed=7)
    pload = pdp.DeviceTrainLoader(
        pdp.DeviceCachedDataset(_samples(Sample), pcfg, torch.device("cpu")),
        pcfg, seed=7)
    assert pload.steps_per_epoch() == jload.steps_per_epoch() == 1
    for epoch in (0, 1):
        for want, got in itertools.zip_longest(jload.epoch(epoch),
                                               pload.epoch(epoch)):
            assert got["image"].shape == (4, 12, 12, 12, 1)
            for k in ("label", "crop_loc", "affine"):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]), err_msg=k)
            want_img = np.asarray(want["image"])
            if channel:
                want_img = _channel_norm64(want_img)
            np.testing.assert_allclose(got["image"].numpy(), want_img,
                                       rtol=0, atol=1e-6)
            assert got["label"].dtype == torch.int32


def test_a_rank_keeps_the_step_count():
    """``steps`` runs the order on through further permutations."""
    cfg = Config(vol_size=12, n_images_per_batch=2)
    ds = pdp.DeviceCachedDataset(_samples(Sample), cfg, torch.device("cpu"))
    batches = list(pdp.DeviceTrainLoader(ds, cfg, seed=1, steps=4).epoch(0))
    assert len(batches) == 4
    assert all(b["image"].shape[0] == 2 for b in batches)
