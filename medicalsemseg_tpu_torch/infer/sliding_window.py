"""Gaussian-blended sliding-window inference (counterpart of
medicalsemseg_tpu/infer/sliding_window.py).

The window grid, the normalised window centres and the importance map are
computed host-side in NumPy, as in the JAX package (MONAI semantics). The
loop runs eagerly over batches of ``sw_batch`` windows: gather the windows
on the device, call the predictor once per batch, and blend each window's
class-major probabilities into the output and count volumes by indexed adds,
in window order, as the JAX ``fori_loop`` does.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tuple3 = Tuple[int, int, int]


def bucket_pad(vol: np.ndarray, multiple: int = 32,
               cval: float = 0.0) -> Tuple[np.ndarray, Tuple3]:
    """Pad a (D, H, W, C) host volume at its trailing edges to the next
    spatial multiple with air (cval). Returns (padded, original shape)."""
    orig = vol.shape[:3]
    pads = [(0, (-orig[i]) % multiple) for i in range(3)] + [(0, 0)]
    if any(p != (0, 0) for p in pads):
        vol = np.pad(vol, pads, constant_values=cval)
    return vol, orig


def scan_interval(image_size: Tuple3, roi_size: Tuple3,
                  overlap: float) -> Tuple3:
    """MONAI _get_scan_interval semantics."""
    return tuple(roi_size[i] if roi_size[i] == image_size[i]
                 else max(int(roi_size[i] * (1.0 - overlap)), 1)
                 for i in range(3))


def dense_patch_starts(image_size: Tuple3, roi_size: Tuple3,
                       interval: Tuple3) -> np.ndarray:
    """All window start coordinates, clamped to stay in bounds (MONAI
    dense_patch_slices), depth-major. (N, 3) int."""
    per_dim = []
    for d in range(3):
        n = int(math.ceil((image_size[d] - roi_size[d]) / interval[d])) + 1
        starts = []
        for idx in range(n):
            s = idx * interval[d]
            s -= max(s + roi_size[d] - image_size[d], 0)
            starts.append(s)
        per_dim.append(starts)
    return np.asarray(list(itertools.product(*per_dim)), dtype=np.int64)


@functools.lru_cache(maxsize=None)
def gaussian_importance_map(roi_size: Tuple3,
                            sigma_scale: float = 0.125) -> np.ndarray:
    """Separable Gaussian blending weights over a window (fp32, max 1),
    centred at size // 2 with sigma = sigma_scale * size, clamped away from
    zero like MONAI's compute_importance_map."""
    axes = []
    for s in roi_size:
        x = np.arange(s, dtype=np.float64)
        axes.append(np.exp(-0.5 * ((x - s // 2) / (sigma_scale * s)) ** 2))
    g = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    g = g / g.max()
    g = np.maximum(g, max(g[g > 0].min(), 1e-3))
    return g.astype(np.float32)


def sliding_window_inference(
    inputs: torch.Tensor,
    affine: torch.Tensor,
    roi_size: Tuple3,
    sw_batch_size: int,
    predictor: Callable,
    n_classes: int,
    overlap: float = 0.25,
    mode: str = "constant",
    sigma_scale: float = 0.125,
    cval: float = 0.0,
) -> torch.Tensor:
    """inputs (B, D, H, W, C) -> blended logits (B, D, H, W, n_classes) fp32.

    ``predictor((windows (k, *roi, C), centers (k, 3), affine (k, 3)))``
    returns (k, *roi, n_classes) logits, k <= sw_batch_size (the last batch
    of a volume may be short). Volumes smaller than the roi are padded
    symmetrically with ``cval`` and cropped back."""
    b, d0, h0, w0, _ = inputs.shape
    roi = tuple(int(r) for r in roi_size)
    dev = inputs.device

    pads = []
    for i, dim in enumerate((d0, h0, w0)):
        diff = max(roi[i] - dim, 0)
        pads.append((diff // 2, diff - diff // 2))
    image_size = tuple(max((d0, h0, w0)[i], roi[i]) for i in range(3))
    x = F.pad(inputs, (0, 0, *pads[2], *pads[1], *pads[0]), value=cval)

    starts = dense_patch_starts(image_size, roi,
                                scan_interval(image_size, roi, overlap))
    centers = torch.from_numpy(np.stack([
        (starts[:, i] + roi[i] - roi[i] // 2) / image_size[i]
        for i in range(3)], axis=1).astype(np.float32)).to(dev)
    imap = (gaussian_importance_map(roi, sigma_scale) if mode == "gaussian"
            else np.ones(roi, np.float32))
    imap = torch.from_numpy(imap).to(dev)[None]  # (1, *roi)

    results = []
    for bi in range(b):
        out = torch.zeros((n_classes,) + image_size, dtype=torch.float32,
                          device=dev)
        cnt = torch.zeros((1,) + image_size, dtype=torch.float32, device=dev)
        for i0 in range(0, len(starts), sw_batch_size):
            batch = starts[i0:i0 + sw_batch_size]
            wins = torch.stack([x[bi, s0:s0 + roi[0], s1:s1 + roi[1],
                                  s2:s2 + roi[2]] for s0, s1, s2 in batch])
            k = len(batch)
            probs = predictor((wins, centers[i0:i0 + k],
                               affine[bi].expand(k, 3)))
            probs = probs.float().permute(0, 4, 1, 2, 3)  # class-major
            for i, (s0, s1, s2) in enumerate(batch):
                sl = (slice(None), slice(s0, s0 + roi[0]),
                      slice(s1, s1 + roi[1]), slice(s2, s2 + roi[2]))
                out[sl] += imap * probs[i]
                cnt[sl] += imap
        results.append((out / cnt).permute(1, 2, 3, 0))
    result = torch.stack(results)
    return result[:, pads[0][0]:pads[0][0] + d0, pads[1][0]:pads[1][0] + h0,
                  pads[2][0]:pads[2][0] + w0]
