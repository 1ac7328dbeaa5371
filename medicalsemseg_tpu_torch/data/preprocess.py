"""Host-side preprocessing for training, evaluation and prediction, free of
jax.

Counterpart of medicalsemseg_tpu/data/transforms.py (``load_and_preprocess``
and the random crops and augmentations of ``sample_training_crops``, which
draw from an explicit ``np.random.Generator`` in the same order, so that the
same seed gives bit-equal crops) and of the spacing resample in
medicalsemseg_tpu/ops/resize.py. The JAX package's modules import jax on
the way (transforms -> ops.resize), so the NumPy
helpers the port needs live here; NIfTI I/O (``data/nifti.py``) and the
binding of the native resampler (``data/native.py``) are the port's own
copies.

Volumes are channels-last (D, H, W, C) numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from medicalsemseg_tpu_torch.config import Config, as_tuple3
from medicalsemseg_tpu_torch.data import native, nifti

Tuple3 = Tuple[int, int, int]


# ---------------------------------------------------------------- intensity

def scale_intensity_range(img, a_min, a_max, b_min=0.0, b_max=1.0, clip=True):
    """MONAI ScaleIntensityRanged."""
    img = (img.astype(np.float32) - a_min) / float(a_max - a_min)
    img = img * (b_max - b_min) + b_min
    if clip:
        img = np.clip(img, b_min, b_max)
    return img.astype(np.float32)


def scale_cubed_intensity_range(img, a_min, a_max, b_min=0.0, b_max=1.0,
                                clip=True):
    """Cube-root compression, then min-max scaling."""
    ca, cb = np.cbrt(a_min), np.cbrt(a_max)
    img = (np.cbrt(img.astype(np.float32)) - ca) / (cb - ca)
    img = img * (b_max - b_min) + b_min
    if clip:
        img = np.clip(img, b_min, b_max)
    return img.astype(np.float32)


def scale_intensity_range_percentiles(img, lower=5.0, upper=95.0, b_min=0.0,
                                      b_max=1.0, clip=True):
    """MONAI ScaleIntensityRangePercentilesd(relative=False)."""
    return scale_intensity_range(img, np.percentile(img, lower),
                                 np.percentile(img, upper), b_min, b_max, clip)


def normalize_intensity(img, subtrahend: Optional[float] = None,
                        divisor: Optional[float] = None,
                        nonzero: bool = False, channel_wise: bool = False):
    """MONAI NormalizeIntensityd."""
    img = img.astype(np.float32)
    if channel_wise:
        out = img.copy()
        for c in range(img.shape[-1]):
            ch = img[..., c]
            mask = ch != 0 if nonzero else np.ones_like(ch, bool)
            if not mask.any():
                continue
            out[..., c][mask] = ((ch[mask] - ch[mask].mean())
                                 / max(ch[mask].std(), 1e-8))
        return out
    return (img - subtrahend) / divisor


def rand_shift_intensity(img, offsets: float, rng: np.random.Generator):
    return img + np.float32(rng.uniform(-offsets, offsets))


def rand_scale_intensity(img, factors: float, rng: np.random.Generator):
    return img * np.float32(1.0 + rng.uniform(-factors, factors))


# ------------------------------------------------------------------ spatial

def crop_foreground_bbox(img, k_divisible: Optional[Tuple3] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Bounding box (start, end) of img > 0 over channels (MONAI
    CropForegroundd); the whole volume when nothing is positive. With
    ``k_divisible`` the box grows symmetrically to multiples of it and may
    then exceed the volume."""
    fg = (img > 0).any(axis=-1)
    if not fg.any():
        start, end = np.zeros(3, np.int64), np.asarray(fg.shape, np.int64)
    else:
        coords = np.argwhere(fg)
        start, end = coords.min(0), coords.max(0) + 1
    if k_divisible is not None:
        k = np.asarray(k_divisible)
        size = end - start
        extra = np.ceil(size / k).astype(int) * k - size
        start = start - extra // 2
        end = end + (extra - extra // 2)
    return start, end


def crop_with_bbox(img, start, end, constant=0.0):
    """Crop (D, H, W, C) to [start, end), padding what lies outside."""
    shape = np.asarray(img.shape[:3])
    pad_lo, pad_hi = np.maximum(-start, 0), np.maximum(end - shape, 0)
    s, e = np.maximum(start, 0), np.minimum(end, shape)
    out = img[s[0]:e[0], s[1]:e[1], s[2]:e[2]]
    if pad_lo.any() or pad_hi.any():
        pads = [(pad_lo[i], pad_hi[i]) for i in range(3)] + [(0, 0)]
        out = np.pad(out, pads, constant_values=constant)
    return out


def spatial_pad(img, target: Tuple3, constant=0.0):
    """Symmetric pad up to target (MONAI SpatialPadd)."""
    pads = []
    for i in range(3):
        diff = max(target[i] - img.shape[i], 0)
        pads.append((diff // 2, diff - diff // 2))
    pads.append((0, 0))
    if any(p != (0, 0) for p in pads):
        img = np.pad(img, pads, constant_values=constant)
    return img


def _correct_center(center, roi: Tuple3, shape: Tuple3) -> np.ndarray:
    """Clamp a crop centre so that the roi fits inside the volume (MONAI
    correct_crop_centers)."""
    c = np.asarray(center, np.int64)
    lo = np.asarray([r // 2 for r in roi])
    hi = np.asarray([max(shape[i] - roi[i] + roi[i] // 2, lo[i])
                     for i in range(3)])
    return np.minimum(np.maximum(c, lo), hi)


def crop_at_center(img, center, roi: Tuple3):
    start = np.asarray(center) - np.asarray([r // 2 for r in roi])
    return img[start[0]:start[0] + roi[0], start[1]:start[1] + roi[1],
               start[2]:start[2] + roi[2]]


def rand_crop_pos_neg_centers(label, image, roi: Tuple3, pos: float,
                              neg: float, num_samples: int,
                              rng: np.random.Generator,
                              image_threshold: float = 0.0) -> List[np.ndarray]:
    """Centre sampling of MONAI RandCropByPosNegLabeld: with probability
    pos / (pos + neg) a uniformly random foreground voxel is the (clamped)
    crop centre, else a background voxel with image > threshold."""
    fg_mask = (label != 0).any(axis=-1)
    valid = (image > image_threshold).any(axis=-1)
    fg_idx = np.flatnonzero(fg_mask)
    bg_idx = np.flatnonzero((~fg_mask) & valid)
    pos_ratio = pos / max(pos + neg, 1e-12)
    if len(fg_idx) == 0 and len(bg_idx) == 0:
        raise ValueError("no valid crop centers: empty label and image")
    shape = fg_mask.shape
    centers = []
    for _ in range(num_samples):
        use_fg = rng.random() < pos_ratio
        pool = fg_idx if (use_fg and len(fg_idx)) else bg_idx
        if len(pool) == 0:
            pool = fg_idx if len(fg_idx) else bg_idx
        flat = pool[rng.integers(len(pool))]
        center = np.asarray(np.unravel_index(flat, shape))
        centers.append(_correct_center(center, roi, shape))
    return centers


def rand_crop_class_centers(label, image, roi: Tuple3, ratios: Sequence[float],
                            num_samples: int, rng: np.random.Generator,
                            image_threshold: float = 0.0) -> List[np.ndarray]:
    """Centre sampling of MONAI RandCropByLabelClassesd: a class drawn by
    ``ratios``, then a uniform voxel of that class."""
    shape = label.shape[:3]
    lab = label[..., 0]
    valid = (image > image_threshold).any(axis=-1)
    pools = []
    for c in range(len(ratios)):
        mask = lab == c
        if c == 0:
            mask = mask & valid
        pools.append(np.flatnonzero(mask))
    r = np.asarray(ratios, np.float64)
    r = np.where(np.asarray([len(p) > 0 for p in pools]), r, 0.0)
    if r.sum() == 0:
        raise ValueError("no valid class centers")
    r = r / r.sum()
    centers = []
    for _ in range(num_samples):
        c = rng.choice(len(pools), p=r)
        flat = pools[c][rng.integers(len(pools[c]))]
        center = np.asarray(np.unravel_index(flat, shape))
        centers.append(_correct_center(center, roi, shape))
    return centers


def dilated_center_mask(label, n_classes: int, iterations: int = 48
                        ) -> np.ndarray:
    """Each class dilated by ``iterations`` voxels (city-block distance
    transform <= iterations), one channel per class: the sampling mask of
    ``--t_rand_crop_dilated_center``."""
    from scipy.ndimage import distance_transform_cdt

    lab = label[..., 0]
    masks = []
    for c in range(n_classes):
        cls = lab == c
        if not cls.any():
            masks.append(np.zeros_like(cls))
            continue
        masks.append(distance_transform_cdt(~cls, metric="taxicab")
                     <= iterations)
    return np.stack(masks, axis=-1).astype(np.uint8)


def rand_spatial_crop(img_shape, roi: Tuple3, rng: np.random.Generator):
    """Uniform start of RandSpatialCropd(random_size=False)."""
    return np.asarray([rng.integers(0, max(img_shape[i] - roi[i], 0) + 1)
                       for i in range(3)])


def rand_flip(img, label, prob: float, rng: np.random.Generator):
    """Three independent per-axis flips."""
    for ax in range(3):
        if rng.random() < prob:
            img = np.flip(img, axis=ax)
            if label is not None:
                label = np.flip(label, axis=ax)
    return img, label


def rand_rotate90(img, label, prob: float, rng: np.random.Generator,
                  max_k: int = 3):
    """MONAI RandRotate90d over the first two spatial axes."""
    if rng.random() < prob:
        k = int(rng.integers(max_k)) + 1
        img = np.rot90(img, k, axes=(0, 1))
        if label is not None:
            label = np.rot90(label, k, axes=(0, 1))
    return img, label


def convert_labels_to_brats(label: np.ndarray) -> np.ndarray:
    """BRATS multi-channel conversion: TC = 1|4, WT = 1|2|4, ET = 4."""
    lab = label[..., 0]
    tc = np.logical_or(lab == 1, lab == 4)
    return np.stack([tc, np.logical_or(tc, lab == 2), lab == 4],
                    axis=-1).astype(np.float32)


def resample_to_shape(vol: np.ndarray, out_shape, mode: str) -> np.ndarray:
    """Half-pixel resample of (D, H, W[, C]) to out_shape: the native C++
    kernel when it is built, scipy otherwise."""

    def one(ch: np.ndarray) -> np.ndarray:
        if native.available():
            if mode == "nearest":
                return native.resample_nearest(ch, out_shape)
            return native.resample_trilinear(ch.astype(np.float32), out_shape)
        from scipy.ndimage import map_coordinates

        scale = np.asarray(ch.shape) / np.asarray(out_shape)
        grid = np.meshgrid(*[(np.arange(out_shape[i]) + 0.5) * scale[i] - 0.5
                             for i in range(3)], indexing="ij")
        return map_coordinates(ch, grid, order=0 if mode == "nearest" else 1,
                               mode="nearest")

    if vol.ndim == 3:
        return one(vol)
    return np.stack([one(vol[..., c]) for c in range(vol.shape[-1])], axis=-1)


def spacing_resample_np(vol: np.ndarray, affine: np.ndarray,
                        new_spacing: Sequence[float],
                        mode: str = "trilinear"):
    """MONAI Spacingd on a (D, H, W[, C]) volume: the output grid follows the
    affine's voxel spacing; the volume centre stays fixed.
    Returns (resampled volume, new affine)."""
    spacing = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    new_spacing = np.asarray(new_spacing, dtype=np.float64)
    in_shape = np.asarray(vol.shape[:3])
    out_shape = np.maximum(np.ceil(in_shape * spacing / new_spacing),
                           1).astype(int)
    out = resample_to_shape(vol, tuple(int(s) for s in out_shape), mode)
    new_affine = affine.copy().astype(np.float64)
    new_affine[:3, :3] = affine[:3, :3] / np.maximum(spacing, 1e-12) * new_spacing
    center_in = affine[:3, :3] @ ((in_shape - 1) / 2.0) + affine[:3, 3]
    new_affine[:3, 3] = center_in - new_affine[:3, :3] @ ((out_shape - 1) / 2.0)
    return out.astype(vol.dtype, copy=False), new_affine


# -------------------------------------------------------------- pipelines

@dataclass
class Sample:
    """One preprocessed volume in host memory."""

    image: np.ndarray            # (D, H, W, C) float32
    label: Optional[np.ndarray]  # (D, H, W, 1) or None (test)
    affine: np.ndarray           # 4x4 post-transform affine
    original_affine: np.ndarray  # 4x4 on-disk affine (pre-orientation)
    original_shape: Tuple3       # pre-resample spatial shape
    crop_mask: Optional[np.ndarray] = None  # dilated sampling mask (train)
    name: str = ""


def load_and_preprocess(image_path: str, label_path: Optional[str],
                        cfg: Config, mode: str = "test") -> Sample:
    """LoadImaged -> channels-last -> [RAS] -> [Spacingd] -> intensity chain.

    train: reorientation to RAS, crop-foreground (plain and/or k-divisible),
           spatial pad; the normalisation runs per crop in
           :func:`sample_training_crops`, after the intensity augmentations;
    val:   reorientation to RAS, plain crop-foreground, spatial pad, normalise;
    test:  no reorientation, no crop-foreground, no spatial pad, normalise."""
    if mode not in ("train", "val", "test"):
        raise ValueError(f"mode {mode!r}: expected train, val or test")
    is_test = mode == "test"
    img_nii = nifti.load(image_path)
    img, affine = np.asarray(img_nii.data), img_nii.affine
    original_affine = affine.copy()
    if img.ndim == 3:
        img = img[..., None]
    if not is_test:
        img, affine = nifti.to_ras(img, affine)
    ras_affine = affine.copy()
    original_shape = img.shape[:3]

    label = None
    if label_path is not None:
        lab_nii = nifti.load(label_path)
        label = np.asarray(lab_nii.data)
        if label.ndim == 3:
            label = label[..., None]
        if not is_test:
            label, _ = nifti.to_ras(label, lab_nii.affine)

    if cfg.t_voxel_spacings:
        dims = as_tuple3(cfg.t_voxel_dims)
        img, affine = spacing_resample_np(img, affine, dims, mode="trilinear")
        if label is not None:
            label, _ = spacing_resample_np(label, ras_affine, dims,
                                           mode="nearest")

    if cfg.t_cubed_ct_intensity:
        img = scale_cubed_intensity_range(img, cfg.t_ct_min, cfg.t_ct_max)
    elif cfg.t_fixed_ct_intensity:
        img = scale_intensity_range(img, cfg.t_ct_min, cfg.t_ct_max)
    elif cfg.t_percentile_ct_intensity:
        img = scale_intensity_range_percentiles(img)

    if cfg.t_convert_labels_to_brats and label is not None and cfg.in_chans > 1:
        label = convert_labels_to_brats(label)

    if not is_test:
        do_kdiv = cfg.t_crop_foreground_kdiv and mode == "train"
        if cfg.t_crop_foreground_img or do_kdiv:
            start, end = crop_foreground_bbox(
                img, k_divisible=cfg.vol_size3() if do_kdiv else None)
            img = crop_with_bbox(img, start, end)
            if label is not None:
                label = crop_with_bbox(label, start, end)
        if cfg.t_spatial_pad:
            img = spatial_pad(img, cfg.vol_size3())
            if label is not None:
                label = spatial_pad(label, cfg.vol_size3())

    if cfg.t_normalize and mode != "train":
        img = _normalize(img, cfg)

    crop_mask = None
    if cfg.t_rand_crop_dilated_center and label is not None and mode == "train":
        crop_mask = dilated_center_mask(label, cfg.output_dim)

    return Sample(image=np.ascontiguousarray(img, np.float32),
                  label=None if label is None else np.ascontiguousarray(label),
                  affine=affine, original_affine=original_affine,
                  original_shape=original_shape, crop_mask=crop_mask,
                  name=image_path)


def _normalize(img, cfg: Config):
    if cfg.t_normalize_channel_wise:
        return normalize_intensity(img, nonzero=True, channel_wise=True)
    return normalize_intensity(img, cfg.t_norm_mean, cfg.t_norm_std)


def sample_training_crops(sample: Sample, cfg: Config,
                          rng: np.random.Generator
                          ) -> List[Dict[str, np.ndarray]]:
    """Random crop and augmentation, the per-step random suffix of the train
    pipeline. Returns ``t_n_patches_per_image`` dicts with image / label /
    crop_loc / affine entries of static shapes."""
    roi = cfg.vol_size3()
    # the roi must fit (MONAI's crops pad on demand; here up front)
    img = spatial_pad(sample.image, roi)
    label = None if sample.label is None else spatial_pad(sample.label, roi)
    n = cfg.t_n_patches_per_image
    shape = img.shape[:3]

    if cfg.t_rand_crop_fgbg or cfg.t_rand_crop_dilated_center:
        lab_for_crop = label
        if cfg.t_rand_crop_dilated_center:
            lab_for_crop = sample.crop_mask
            if lab_for_crop is not None:
                lab_for_crop = spatial_pad(lab_for_crop, roi)
        centers = rand_crop_pos_neg_centers(
            lab_for_crop, img, roi, cfg.t_rand_crop_pos_weight,
            cfg.t_rand_crop_neg_weight, n, rng)
    elif cfg.t_rand_crop_classes:
        ratios = np.full(cfg.output_dim, cfg.t_rand_crop_pos_weight)
        ratios[0] = cfg.t_rand_crop_neg_weight
        centers = rand_crop_class_centers(label, img, roi, ratios, n, rng)
    elif cfg.t_rand_spatial_crop:
        half = np.asarray([r // 2 for r in roi])
        centers = [rand_spatial_crop(shape, roi, rng) + half for _ in range(n)]
    else:
        centers = [np.asarray([s // 2 for s in shape])] * n

    affine_xyz = np.diag(sample.original_affine)[:3].astype(np.float32)
    out = []
    for center in centers:
        ci = crop_at_center(img, center, roi)
        cl = crop_at_center(label, center, roi) if label is not None else None
        ci, cl = rand_flip(ci, cl, cfg.t_flip_prob, rng)
        ci, cl = rand_rotate90(ci, cl, cfg.t_rot_prob, rng)
        if (cfg.t_intensity_shift_prob > 0
                and rng.random() < cfg.t_intensity_shift_prob):
            ci = rand_shift_intensity(ci, cfg.t_intensity_shift_os, rng)
        if (cfg.t_intensity_scale_prob > 0
                and rng.random() < cfg.t_intensity_scale_prob):
            ci = rand_scale_intensity(ci, cfg.t_intensity_scale_factors, rng)
        if cfg.t_normalize:
            ci = _normalize(ci, cfg)
        # relative crop location = centre / volume size
        crop_loc = np.asarray(center, np.float32) / np.asarray(shape, np.float32)
        out.append({
            "image": np.ascontiguousarray(ci, np.float32),
            "label": None if cl is None else
                     np.ascontiguousarray(cl[..., 0]).astype(np.int32),
            "crop_loc": crop_loc,
            "affine": affine_xyz,
        })
    return out
