"""Synthetic abdominal CT from a seed, made on the device in batched draws.

Each volume is a body (an ellipsoid of soft tissue in air) holding organs:
every organ class is present with probability ``PRESENT``, as an ellipsoid
of its own intensity at a random place and size, later classes over earlier
ones; Gaussian noise on top. Intensities are HU scaled from [-1000, 1000]
to [0, 1], as the port's fixed CT window does. Crops differ in which organs
they hold, so their losses differ and a fault that drops part of a batch
shows in the loss.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

PRESENT = 0.7
NOISE = 0.02


def _hu(v: float) -> float:
    return (v + 1000.0) / 2000.0


def ct_volumes(n: int, shape: Sequence[int], n_classes: int,
               generator: torch.Generator, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, *shape) fp32 images and (n, *shape) int32 labels."""
    g = generator

    def u(*size, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*size, generator=g, device=device)

    axes = [torch.linspace(-1.0, 1.0, s, device=device) for s in shape]
    zz = axes[0].view(1, -1, 1, 1)
    yy = axes[1].view(1, 1, -1, 1)
    xx = axes[2].view(1, 1, 1, -1)

    def inside(center, radii):
        c = center.view(-1, 3, 1, 1, 1)
        r = radii.view(-1, 3, 1, 1, 1)
        return (((zz - c[:, 0]) / r[:, 0]) ** 2 + ((yy - c[:, 1]) / r[:, 1]) ** 2
                + ((xx - c[:, 2]) / r[:, 2]) ** 2) < 1.0

    body = inside(u(n, 3, lo=-0.05, hi=0.05), u(n, 3, lo=0.8, hi=1.0))
    image = torch.where(body, _hu(40.0), _hu(-1000.0)).float()
    label = torch.zeros((n,) + tuple(shape), dtype=torch.int32, device=device)
    k = n_classes - 1
    present = u(n, k) < PRESENT
    centers = u(n, k, 3, lo=-0.6, hi=0.6)
    radii = u(n, k, 3, lo=0.08, hi=0.35)
    levels = u(n, k, lo=_hu(-100.0), hi=_hu(300.0))
    for c in range(k):
        m = inside(centers[:, c], radii[:, c]) & body \
            & present[:, c].view(-1, 1, 1, 1)
        image = torch.where(m, levels[:, c].view(-1, 1, 1, 1), image)
        label = torch.where(m, torch.full_like(label, c + 1), label)
    image = image + NOISE * torch.randn(image.shape, generator=g,
                                        device=device)
    return image, label
