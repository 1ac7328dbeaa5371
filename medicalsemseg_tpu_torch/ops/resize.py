"""Linear resize (counterpart of medicalsemseg_tpu/ops/resize.py:
``resize_trilinear``, of the ``jax.image.resize(..., "linear")`` in the
GC-ViT stage and of the ``jax.image.resize(..., "bilinear")`` in the Swin2D
segmentation head).

Half-pixel centres and a triangle kernel, separable: one (out, in) weight
matrix per axis, built in NumPy and cached, applied as a matmul along that
axis of the channels-last tensor. Upsampling gives
``F.interpolate(mode="trilinear", align_corners=False)``. Shrinking widens
the triangle by the scale factor (antialiasing), as ``jax.image.resize``
does and ``F.interpolate`` does not.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) fp32 resize matrix: row o holds the triangle-kernel weights
    of output sample o over the input samples, normalised to sum 1 (so edges
    repeat the border value)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=np.float64)[None, :])
    w = np.maximum(0.0, 1.0 - x / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def resize_linear(x: torch.Tensor, out_size: Tuple[int, ...]) -> torch.Tensor:
    """(B, *spatial, C) -> (B, *out_size, C), one spatial axis after the
    other: trilinear for volumes, bilinear for images; the weights are cast
    to ``x.dtype`` and the products accumulate in fp32 on the card."""
    for axis, size in enumerate(out_size, start=1):
        n_in = x.shape[axis]
        if n_in == size:
            continue
        w = torch.from_numpy(linear_weights(n_in, int(size))).to(
            device=x.device, dtype=x.dtype)
        lead = x.shape[:axis]
        rest = x.shape[axis + 1:]
        y = torch.matmul(w, x.reshape(int(np.prod(lead)), n_in,
                                      int(np.prod(rest))))
        x = y.reshape(*lead, int(size), *rest)
    return x


def resize_trilinear(x: torch.Tensor,
                     out_size: Tuple[int, int, int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, *out_size, C), half-pixel trilinear."""
    return resize_linear(x, tuple(int(s) for s in out_size))
