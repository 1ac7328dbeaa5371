"""Device-resident training data pipeline (counterpart of
medicalsemseg_tpu/data/device_pipeline.py).

The preprocessed volumes are padded to the roi and to a bucket multiple
once and stay on the card. Each step the host draws only scalars (crop
centres against precomputed foreground / background index tables, flip
bits, the rot90 k, the intensity shift and scale) with the same
``np.random.Generator`` calls in the same order as the JAX package, so one
seed gives the same batches there and here; the crop, the flips, the rot90,
the intensity change and the normalisation run as PyTorch ops on the card
(the JAX package runs them under XLA, with no Pallas kernel). Fits when the
dataset fits the card beside the train state (BTCV: ~30 volumes x 240^3
fp32 ~ 1.6 GB).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from medicalsemseg_tpu_torch.config import Config
from medicalsemseg_tpu_torch.data.dataset import CachedVolumeDataset, epoch_order
from medicalsemseg_tpu_torch.data.preprocess import spatial_pad
from medicalsemseg_tpu_torch.infer.sliding_window import bucket_pad


def _extract_and_augment(image: torch.Tensor, label: torch.Tensor,
                         center, flip_bits, rot_k: int, shift: float,
                         scale: float, mean: float, std: float, *,
                         roi: Tuple[int, int, int], norm: str = "none"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop at ``center`` (the start is center - roi // 2, clamped on the
    host), flip the axes whose ``flip_bits`` are set, rot90 by ``rot_k``
    over the first two spatial axes, ``x * scale + shift``, then normalise:
    ``scalar`` (x - mean) / std, ``channel`` each channel standardised over
    its nonzero voxels of the crop (statistics in float64). image (D, H, W, C), label (D, H, W) on
    the card; the host scalars steer Python control flow, so nothing is read
    back."""
    s = [int(c) - r // 2 for c, r in zip(center, roi)]
    sl = tuple(slice(a, a + r) for a, r in zip(s, roi))
    img, lab = image[sl], label[sl]
    dims = [ax for ax in range(3) if flip_bits[ax]]
    if dims:
        img, lab = img.flip(dims), lab.flip(dims)
    if rot_k:
        img = torch.rot90(img, int(rot_k), dims=(0, 1))
        lab = torch.rot90(lab, int(rot_k), dims=(0, 1))
    img = img * scale + shift
    if norm == "scalar":
        img = (img - mean) / std
    elif norm == "channel":
        # float64 statistics: the sums' order (the card's, the CPU's,
        # XLA's) then moves the fp32 result by an ulp at most
        x = img.double()
        mask = x != 0
        cnt = mask.sum((0, 1, 2))
        safe = torch.clamp(cnt, min=1)
        mu = torch.where(mask, x, 0.0).sum((0, 1, 2)) / safe
        var = torch.where(mask, (x - mu) ** 2, 0.0).sum((0, 1, 2)) / safe
        std_c = torch.clamp(torch.sqrt(var), min=1e-8)
        img = torch.where(mask & (cnt > 0), (x - mu) / std_c, x).float()
    return img.contiguous(), lab.contiguous()


class DeviceCachedDataset:
    """Card-resident volumes and the host's centre sampling tables."""

    def __init__(self, host_ds: CachedVolumeDataset, cfg: Config,
                 device: torch.device, bucket: int = 32):
        self.cfg, self.device = cfg, device
        self.roi = cfg.vol_size3()
        self.images: List[torch.Tensor] = []
        self.labels: List[torch.Tensor] = []
        self.fg_indices: List[np.ndarray] = []
        self.bg_indices: List[np.ndarray] = []
        self.shapes: List[Tuple[int, int, int]] = []
        self.affines: List[np.ndarray] = []
        for i in range(len(host_ds)):
            s = host_ds[i]
            img, _ = bucket_pad(spatial_pad(s.image, self.roi), bucket)
            lab, _ = bucket_pad(spatial_pad(s.label, self.roi), bucket)
            lab2 = lab[..., 0].astype(np.int32)
            self.images.append(torch.from_numpy(
                np.ascontiguousarray(img, np.float32)).to(device))
            self.labels.append(torch.from_numpy(lab2).to(device))
            fg = lab2 != 0
            valid = (img > 0).any(axis=-1)
            self.fg_indices.append(np.flatnonzero(fg))
            self.bg_indices.append(np.flatnonzero(~fg & valid))
            self.shapes.append(lab2.shape)
            self.affines.append(s.original_affine)

    def __len__(self) -> int:
        return len(self.images)

    def _sample_center(self, idx: int, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        pos_ratio = cfg.t_rand_crop_pos_weight / max(
            cfg.t_rand_crop_pos_weight + cfg.t_rand_crop_neg_weight, 1e-12)
        pool = (self.fg_indices[idx]
                if (rng.random() < pos_ratio and len(self.fg_indices[idx]))
                else self.bg_indices[idx])
        if len(pool) == 0:
            pool = self.fg_indices[idx] if len(self.fg_indices[idx]) else \
                np.asarray([0])
        shape = self.shapes[idx]
        center = np.asarray(np.unravel_index(pool[rng.integers(len(pool))],
                                             shape))
        lo = np.asarray([r // 2 for r in self.roi])
        hi = np.asarray([shape[i] - self.roi[i] + self.roi[i] // 2
                         for i in range(3)])
        return np.minimum(np.maximum(center, lo), hi)

    def draw(self, idx: int, rng: np.random.Generator) -> Dict:
        """The host's draws for one crop of volume ``idx``, in the JAX
        package's order: centre, flips, rot90 k, shift, scale."""
        cfg = self.cfg
        center = self._sample_center(idx, rng)
        flips = (rng.random(3) < cfg.t_flip_prob) if cfg.t_flip_prob > 0 \
            else np.zeros(3, bool)
        rot_k = (int(rng.integers(3)) + 1
                 if (cfg.t_rot_prob > 0 and rng.random() < cfg.t_rot_prob)
                 else 0)
        shift = (np.float32(rng.uniform(-cfg.t_intensity_shift_os,
                                        cfg.t_intensity_shift_os))
                 if (cfg.t_intensity_shift_prob > 0
                     and rng.random() < cfg.t_intensity_shift_prob)
                 else np.float32(0.0))
        scale = (np.float32(1.0 + rng.uniform(-cfg.t_intensity_scale_factors,
                                              cfg.t_intensity_scale_factors))
                 if (cfg.t_intensity_scale_prob > 0
                     and rng.random() < cfg.t_intensity_scale_prob)
                 else np.float32(1.0))
        return {"center": center, "flips": flips, "rot_k": rot_k,
                "shift": float(shift), "scale": float(scale)}

    def sample_crop(self, idx: int, rng: np.random.Generator
                    ) -> Dict[str, torch.Tensor]:
        """One augmented crop: the batch entries, on the card."""
        cfg = self.cfg
        d = self.draw(idx, rng)
        norm = "none"
        if cfg.t_normalize:
            norm = "channel" if cfg.t_normalize_channel_wise else "scalar"
        img, lab = _extract_and_augment(
            self.images[idx], self.labels[idx], d["center"], d["flips"],
            d["rot_k"], d["shift"], d["scale"],
            float(np.float32(cfg.t_norm_mean)),
            float(np.float32(cfg.t_norm_std)), roi=self.roi, norm=norm)
        crop_loc = (d["center"] / np.asarray(self.shapes[idx])).astype(
            np.float32)
        affine_xyz = np.diag(self.affines[idx])[:3].astype(np.float32)
        return {"image": img, "label": lab,
                "crop_loc": torch.from_numpy(crop_loc).to(self.device),
                "affine": torch.from_numpy(affine_xyz).to(self.device)}


class DeviceTrainLoader:
    """Epoch iterator over card-side crops, batched as ``TrainLoader``:
    ``n_images_per_batch`` volumes of the epoch's permutation a step,
    ``t_n_patches_per_image`` crops each, every draw from one generator
    seeded (seed, epoch). ``steps`` fixes the steps of an epoch, as
    ``TrainLoader``'s does."""

    def __init__(self, ds: DeviceCachedDataset, cfg: Config, seed: int = 0,
                 steps: Optional[int] = None):
        self.ds, self.cfg, self.seed, self.steps = ds, cfg, seed, steps

    def steps_per_epoch(self) -> int:
        if self.steps is not None:
            return self.steps
        return max(len(self.ds) // self.cfg.n_images_per_batch, 1)

    def epoch(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        nb = self.cfg.n_images_per_batch
        order = epoch_order(rng, len(self.ds), 0 if self.steps is None
                            else self.steps_per_epoch() * nb)
        for b in range(self.steps_per_epoch()):
            idxs = order[b * nb:(b + 1) * nb]
            if len(idxs) < nb:
                idxs = np.concatenate([idxs, order[:nb - len(idxs)]])
            crops = [self.ds.sample_crop(int(i), rng) for i in idxs
                     for _ in range(self.cfg.t_n_patches_per_image)]
            yield {k: torch.stack([c[k] for c in crops]) for k in crops[0]}
