"""Host-side preprocessing for evaluation and prediction, free of jax.

Counterpart of the val/test modes of medicalsemseg_tpu/data/transforms.py
``load_and_preprocess``, of the spacing resample in
medicalsemseg_tpu/ops/resize.py, and of ``CachedVolumeDataset`` /
``EvalLoader`` in medicalsemseg_tpu/data/dataset.py. The JAX package's
modules import jax on the way (transforms -> ops.resize), so the NumPy
helpers the port needs live here; NIfTI I/O and the native resampler are the
JAX package's own jax-free modules.

Volumes are channels-last (D, H, W, C) numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from medicalsemseg_tpu.config import Config, as_tuple3
from medicalsemseg_tpu.data import native, nifti

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


# ------------------------------------------------------------------ spatial

def crop_foreground_bbox(img) -> Tuple[np.ndarray, np.ndarray]:
    """Bounding box (start, end) of img > 0 over channels (MONAI
    CropForegroundd); the whole volume when nothing is positive."""
    fg = (img > 0).any(axis=-1)
    if not fg.any():
        return np.zeros(3, np.int64), np.asarray(fg.shape, np.int64)
    coords = np.argwhere(fg)
    return coords.min(0), coords.max(0) + 1


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
    name: str = ""


def load_and_preprocess(image_path: str, label_path: Optional[str],
                        cfg: Config, mode: str = "test") -> Sample:
    """LoadImaged -> channels-last -> [RAS] -> [Spacingd] -> intensity chain.

    val:  reorientation to RAS, plain crop-foreground, spatial pad, normalise;
    test: no reorientation, no crop-foreground, no spatial pad, normalise.
    The training pipeline (random crops and augmentation) is not ported."""
    if mode not in ("val", "test"):
        raise NotImplementedError(
            f"mode {mode!r}: the training pipeline is not ported yet "
            "(ROADMAP queue 1 item 9, training)")
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
        raise NotImplementedError("--t_convert_labels_to_brats is not ported "
                                  "yet (ROADMAP queue 1 item 9, training)")

    if not is_test:
        if cfg.t_crop_foreground_img:
            start, end = crop_foreground_bbox(img)
            img = img[start[0]:end[0], start[1]:end[1], start[2]:end[2]]
            if label is not None:
                label = label[start[0]:end[0], start[1]:end[1],
                              start[2]:end[2]]
        if cfg.t_spatial_pad:
            img = spatial_pad(img, cfg.vol_size3())
            if label is not None:
                label = spatial_pad(label, cfg.vol_size3())

    if cfg.t_normalize:
        if cfg.t_normalize_channel_wise:
            img = normalize_intensity(img, nonzero=True, channel_wise=True)
        else:
            img = normalize_intensity(img, cfg.t_norm_mean, cfg.t_norm_std)

    return Sample(image=np.ascontiguousarray(img, np.float32),
                  label=None if label is None else np.ascontiguousarray(label),
                  affine=affine, original_affine=original_affine,
                  original_shape=original_shape, name=image_path)


class CachedVolumeDataset:
    """Preprocessed volumes; the first ``cache_rate`` share is kept in host
    memory, the rest is preprocessed on access."""

    def __init__(self, files: Sequence[Dict], cfg: Config,
                 cache_rate: float = 1.0, mode: str = "test"):
        self.files = list(files)
        self.cfg, self.mode = cfg, mode
        self._cache: Dict[int, Sample] = {
            i: self._load(i) for i in range(int(len(self.files) * cache_rate))}

    def _load(self, idx: int) -> Sample:
        f = self.files[idx]
        return load_and_preprocess(f["image"], f.get("label"), self.cfg,
                                   mode=self.mode)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Sample:
        return self._cache[idx] if idx in self._cache else self._load(idx)


class EvalLoader:
    """Whole-volume iterator for evaluation and prediction (batch size 1)."""

    def __init__(self, dataset: CachedVolumeDataset):
        self.ds = dataset

    def __len__(self) -> int:
        return len(self.ds)

    def __iter__(self) -> Iterator[Sample]:
        for i in range(len(self.ds)):
            yield self.ds[i]

