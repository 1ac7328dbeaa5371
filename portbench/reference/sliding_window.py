"""Plain fp32 reference of Gaussian sliding-window prediction (MONAI's
``sliding_window_inference`` with ``mode="gaussian"``), after the volume is
padded at its trailing edges to a multiple of ``multiple`` voxels."""

from __future__ import annotations

import itertools
import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_map(roi: Sequence[int], sigma_scale: float = 0.125
                 ) -> np.ndarray:
    """Separable Gaussian weights centred at size // 2, sigma
    sigma_scale * size, peak 1, floored at its least positive value or
    1e-3, whichever is larger."""
    g = np.ones((), np.float64)
    for s in roi:
        x = np.arange(s, dtype=np.float64)
        g = np.multiply.outer(g, np.exp(-0.5 * ((x - s // 2)
                                                / (sigma_scale * s)) ** 2))
    g = g / g.max()
    return np.maximum(g, max(g[g > 0].min(), 1e-3)).astype(np.float32)


def window_starts(size: Sequence[int], roi: Sequence[int],
                  overlap: float) -> list:
    per_axis = []
    for s, r in zip(size, roi):
        step = r if r == s else max(int(r * (1.0 - overlap)), 1)
        n = int(math.ceil((s - r) / step)) + 1
        per_axis.append([i * step - max(i * step + r - s, 0)
                         for i in range(n)])
    return list(itertools.product(*per_axis))


@torch.no_grad()
def predict(forward: Callable, volume: np.ndarray, roi: Sequence[int],
            n_classes: int, overlap: float, multiple: int, device,
            windows_per_call: int = 2) -> torch.Tensor:
    """Logits (D, H, W, n_classes) fp32 on ``device`` of a host volume
    (D, H, W, 1); ``forward(windows)`` maps (k, *roi, 1) to (k, *roi,
    n_classes)."""
    orig = volume.shape[:3]
    x = torch.from_numpy(np.ascontiguousarray(volume)).to(device).float()
    x = F.pad(x, (0, 0, 0, (-orig[2]) % multiple, 0, (-orig[1]) % multiple,
                  0, (-orig[0]) % multiple))
    sym = [max(r - s, 0) for r, s in zip(roi, x.shape[:3])]
    x = F.pad(x, (0, 0, sym[2] // 2, sym[2] - sym[2] // 2, sym[1] // 2,
                  sym[1] - sym[1] // 2, sym[0] // 2, sym[0] - sym[0] // 2))
    size = x.shape[:3]
    wmap = torch.from_numpy(gaussian_map(roi)).to(device)[..., None]
    out = torch.zeros(*size, n_classes, device=device)
    cnt = torch.zeros(*size, 1, device=device)
    starts = window_starts(size, roi, overlap)
    for i in range(0, len(starts), windows_per_call):
        batch = starts[i:i + windows_per_call]
        wins = torch.stack([x[a:a + roi[0], b:b + roi[1], c:c + roi[2]]
                            for a, b, c in batch])
        logits = forward(wins)
        for (a, b, c), lg in zip(batch, logits):
            sl = (slice(a, a + roi[0]), slice(b, b + roi[1]),
                  slice(c, c + roi[2]))
            out[sl] += wmap * lg
            cnt[sl] += wmap
    out /= cnt
    lo = [v // 2 for v in sym]
    return out[lo[0]:lo[0] + orig[0], lo[1]:lo[1] + orig[1],
               lo[2]:lo[2] + orig[2]]


def widest_gap(logits: torch.Tensor, labels: torch.Tensor,
               block: int = 16) -> float:
    """The widest gap by which the logit of a given label lies below the
    best logit, over every voxel; ``labels`` (D, H, W) integer, taken in
    blocks of ``block`` planes."""
    gap = 0.0
    for i in range(0, logits.shape[0], block):
        lg = logits[i:i + block]
        lab = labels[i:i + block].to(lg.device).long()
        chosen = torch.gather(lg, -1, lab[..., None])[..., 0]
        gap = max(gap, float((lg.amax(-1) - chosen).max()))
    return gap
