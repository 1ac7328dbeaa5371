"""Patch, position and intensity-class embeddings (counterpart of
medicalsemseg_tpu/models/embeddings.py): the Hounsfield-unit interval
tables, the intensity scalings applied to them, the fixed 3D sin-cos
position table, ``PatchEmbed3D``, LRGFormer's ``PatchEmbedGlobal`` and
``PatchEmbedRegion`` and ``LearnedClassVectors``."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medicalsemseg_tpu_torch.models.layers import Conv3d, LayerNorm, linear

Tuple3 = Tuple[int, int, int]

# Hounsfield-unit interval edges of the learned class vectors; the "LC"
# table is the one of the linear-combination variant
HU_INTENSITY_INTERVALS_LC = np.array(
    [-1000, -650, -250, -75, -30, 0, 15, 30, 60, 100, 450, 1000],
    dtype=np.float64)
HU_INTENSITY_INTERVALS = np.array(
    [-1000, -900, -400, -100, -50, -10, 20, 40, 60, 100, 800, 1000],
    dtype=np.float64)


def scale_intensity_range(x: np.ndarray, a_min: float, a_max: float,
                          b_min: float = 0.0, b_max: float = 1.0,
                          clip: bool = True) -> np.ndarray:
    """MONAI ``ScaleIntensityRange`` on a NumPy array: [a_min, a_max] ->
    [b_min, b_max], clipped."""
    y = (x - a_min) / (a_max - a_min) * (b_max - b_min) + b_min
    return np.clip(y, b_min, b_max) if clip else y


def scale_intensity_range_percentiles(x: np.ndarray, lower: float = 5.0,
                                      upper: float = 95.0, b_min: float = 0.0,
                                      b_max: float = 1.0,
                                      clip: bool = True) -> np.ndarray:
    """MONAI ``ScaleIntensityRangePercentiles(relative=False)``: the
    ``lower`` and ``upper`` percentiles of ``x`` itself map to b_min and
    b_max."""
    xp = np.asarray(x)
    return scale_intensity_range(x, float(np.percentile(xp, lower)),
                                 float(np.percentile(xp, upper)), b_min,
                                 b_max, clip)


def get_1d_sincos_pos_embed_from_grid(embed_dim: int,
                                      pos: np.ndarray) -> np.ndarray:
    """(M, embed_dim) float64: sin then cos of the positions times
    1 / 10000^(2 i / embed_dim)."""
    if embed_dim % 2:
        raise ValueError(f"sin-cos embedding width {embed_dim} is odd")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_3d_sincos_pos_embed(embed_dim: int, grid_size) -> np.ndarray:
    """(D * H * W, embed_dim) float64 fixed 3D sin-cos table: a third of the
    width for each axis, the grid in 'ij' order (axis 0 is depth)."""
    if isinstance(grid_size, int):
        grid_size = (grid_size,) * 3
    if embed_dim % 3:
        raise ValueError(f"3D sin-cos embedding needs a width divisible by "
                         f"3, got {embed_dim}")
    grids = np.meshgrid(*[np.arange(g, dtype=np.float32) for g in grid_size],
                        indexing="ij")
    return np.concatenate([get_1d_sincos_pos_embed_from_grid(
        embed_dim // 3, g) for g in grids], axis=1)


class PatchEmbed3D(nn.Module):
    """(B, D, H, W, Cin) -> (B, D/pd, H/ph, W/pw, C): a kernel = stride =
    patch conv, then LayerNorm (none with ``use_norm=False``, ViT's stem).
    The patch may differ per axis. Trailing edges are zero-padded up to a
    multiple of the patch."""

    def __init__(self, patch_size: Tuple3, in_chans: int, embed_dim: int,
                 use_norm: bool = True):
        super().__init__()
        self.patch = tuple(int(p) for p in patch_size)
        self.proj = Conv3d(in_chans, embed_dim, self.patch, stride=self.patch,
                           padding=0)
        self.norm = LayerNorm(embed_dim) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = [(-x.shape[i + 1]) % p for i, p in enumerate(self.patch)]
        if any(pads):
            x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        x = self.proj(x)
        return x if self.norm is None else self.norm(x)


def patch_linear(x: torch.Tensor, conv: Conv3d) -> torch.Tensor:
    """A VALID conv whose kernel equals its stride (``conv.stride``, one per
    axis) on (B, D, H, W, Cin), as one dense layer over each block's voxels:
    (B, D/kd, H/kh, W/kw, O). Trailing voxels that fill no block are
    dropped, as VALID drops them."""
    kd, kh, kw = _k3(conv.stride)
    b, d, h, w, c = x.shape
    gd, gh, gw = d // kd, h // kh, w // kw
    x = x[:, :gd * kd, :gh * kh, :gw * kw]
    x = x.reshape(b, gd, kd, gh, kh, gw, kw, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    x = x.reshape(b, gd, gh, gw, kd * kh * kw * c)
    wt = conv.weight.permute(0, 2, 3, 4, 1).reshape(conv.weight.shape[0], -1)
    dt = x.dtype
    return F.linear(x, wt.to(dt), None if conv.bias is None
                    else conv.bias.to(dt))


def _k3(k) -> Tuple3:
    return (k,) * 3 if isinstance(k, int) else tuple(int(v) for v in k)


class PatchEmbedGlobal(nn.Module):
    """The whole volume -> ONE global token: two 2^3 stride-2 convs, then a
    conv whose kernel is the quartered volume, then LayerNorm (the JAX
    ``PatchEmbedGlobal``). (B, D, H, W, Cin) -> (B, 1, 1, 1, C); the convs
    run as :func:`patch_linear`."""

    def __init__(self, vol_size: Tuple3, in_chans: int, embed_dim: int):
        super().__init__()
        k = tuple(v // 4 for v in vol_size)
        self.down1 = Conv3d(in_chans, 2 * in_chans, 2, stride=2, padding=0)
        self.down2 = Conv3d(2 * in_chans, 4 * in_chans, 2, stride=2,
                            padding=0)
        self.proj = Conv3d(4 * in_chans, embed_dim, k, stride=k, padding=0)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.down1, self.down2, self.proj):
            x = patch_linear(x, conv)
        return self.norm(x)


class PatchEmbedRegion(nn.Module):
    """The volume -> coarse region tokens: one 2^3 stride-2 conv, then a conv
    of half the region size, then LayerNorm (the JAX ``PatchEmbedRegion``).
    (B, D, H, W, Cin) -> (B, D/r, H/r, W/r, C) for region size r; the convs
    run as :func:`patch_linear`."""

    def __init__(self, region_size: Tuple3, in_chans: int, embed_dim: int):
        super().__init__()
        k = tuple(v // 2 for v in region_size)
        self.down = Conv3d(in_chans, 2 * in_chans, 2, stride=2, padding=0)
        self.proj = Conv3d(2 * in_chans, embed_dim, k, stride=k, padding=0)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(patch_linear(patch_linear(x, self.down), self.proj))


class LearnedClassVectors(nn.Module):
    """Patch embeddings from the membership of each voxel's intensity in
    the HU interval table (the JAX ``LearnedClassVectors``). The table is
    the intensity transform of the HU edges through ``np.unique``.

    Variants: by default a learned vector per interval (the interval index
    is ``searchsorted(..., right=True)``, 0 .. len(table)), a patch being its
    P^3 voxels' vectors flattened; ``sincos_emb``: a sin-cos code of the
    intensity placed within its interval; ``linear_comb``: a blend of the
    two neighbouring intervals' vectors; ``concat_vector``: constant one-hot
    vectors (``eye``) summed over the patch, a histogram;
    ``patch_voxel_mean``: the mean of the patch's vectors; ``final_layer``:
    a dense layer from the pooled vector to ``out_dim``. Voxels group into
    true P^3 blocks of the patch."""

    def __init__(self, patch_size: Tuple3, out_dim: int, vector_dim: int,
                 intensity_transform: Optional[Callable] = None,
                 sincos_emb: bool = False, final_layer: bool = False,
                 concat_vector: bool = False, linear_comb: bool = False,
                 patch_voxel_mean: bool = False):
        super().__init__()
        self.patch = tuple(int(p) for p in patch_size)
        self.vector_dim = vector_dim
        self.sincos_emb, self.linear_comb = sincos_emb, linear_comb
        self.concat_vector = concat_vector
        self.patch_voxel_mean = patch_voxel_mean
        base = (HU_INTENSITY_INTERVALS_LC if linear_comb
                else HU_INTENSITY_INTERVALS)
        table = (np.unique(intensity_transform(base))
                 if intensity_transform is not None else base)
        self.register_buffer("intervals", torch.tensor(
            np.asarray(table, np.float32)), persistent=False)
        n_ivals = len(table)
        if sincos_emb:
            self.n_intervals = n_ivals - 1
            if vector_dim % 2:
                raise ValueError("sin-cos class vectors need an even "
                                 f"--lcv_vector_dim, got {vector_dim}")
        elif linear_comb:
            self.n_intervals = n_ivals
        else:
            self.n_intervals = n_ivals + 1
        pooled = concat_vector or patch_voxel_mean
        if final_layer and pooled and vector_dim != self.n_intervals:
            raise ValueError(f"--lcv_vector_dim {vector_dim} must equal the "
                             f"{self.n_intervals} intervals")
        if not final_layer and patch_voxel_mean and vector_dim != out_dim:
            raise ValueError(f"--lcv_vector_dim {vector_dim} must equal the "
                             f"embedding width {out_dim}")
        self.fc = nn.Linear(vector_dim if pooled else
                            int(np.prod(self.patch)) * vector_dim,
                            out_dim) if final_layer else None
        if sincos_emb:
            self.vectors = None
        elif concat_vector:
            self.register_buffer("vectors", torch.eye(
                self.n_intervals, vector_dim), persistent=False)
        else:
            self.vectors = nn.Parameter(torch.zeros(self.n_intervals,
                                                    vector_dim))

    def _interval_weight(self, x: torch.Tensor):
        """(place of x within its interval, the interval's upper index)."""
        iv = self.intervals
        xc = torch.clamp(x, iv[0], iv[-1])
        idx = torch.searchsorted(iv, xc, right=True).clamp(1, len(iv) - 1)
        a, b = iv[idx - 1], iv[idx]
        return (xc - a) / (b - a), idx

    def _voxel_vectors(self, x: torch.Tensor) -> torch.Tensor:
        """(...) fp32 intensities -> (..., vector_dim) fp32 vectors."""
        if self.sincos_emb:
            w, idx = self._interval_weight(x)
            period = 2.0 / self.n_intervals
            norm_x = w * period + (idx - 1).float() * period - 1.0
            omega = (2.0 ** torch.arange(self.vector_dim // 2,
                                         dtype=torch.float32,
                                         device=x.device)) * np.pi
            res = norm_x[..., None] * omega
            return torch.cat([torch.sin(res), torch.cos(res)], dim=-1)
        vec = self.vectors.float()
        if self.linear_comb:
            w, idx = self._interval_weight(x)
            w = w[..., None]
            return w * vec[idx] + (1.0 - w) * vec[idx - 1]
        return vec[torch.searchsorted(self.intervals, x, right=True)]

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W, 1) -> (B, D/pd, H/ph, W/pw, out_dim) in vol's
        dtype."""
        b, d, h, w, _ = vol.shape
        pd, ph, pw = self.patch
        v = self.vector_dim
        vv = self._voxel_vectors(vol[..., 0].float().contiguous())
        patches = vv.reshape(b, d // pd, pd, h // ph, ph, w // pw, pw, v)
        patches = patches.permute(0, 1, 3, 5, 2, 4, 6, 7)
        if self.concat_vector:
            out = patches.sum(dim=(4, 5, 6))
        elif self.patch_voxel_mean:
            out = patches.mean(dim=(4, 5, 6))
        else:
            out = patches.reshape(b, d // pd, h // ph, w // pw,
                                  pd * ph * pw * v)
        if self.fc is not None:
            out = linear(out.to(vol.dtype), self.fc)
        return out.to(vol.dtype)
