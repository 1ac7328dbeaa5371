"""Test-time augmentation: mirror (flip) averaging (counterpart of
medicalsemseg_tpu/infer/tta.py).

nn-UNet-style mirroring: average the model's softmax output over the 8
combinations of spatial flips, un-flipping each prediction. The wrapped
predictor returns probabilities, so the sliding window blends probabilities:
a Gaussian-weighted arithmetic mean across windows (blending log-probabilities
would be a geometric mean, which can flip the argmax near window seams).
"""

from __future__ import annotations

import itertools
from typing import Callable, Tuple

import torch


def mirror_tta(predictor: Callable, axes: Tuple[int, ...] = (1, 2, 3),
               apply_softmax: bool = True) -> Callable:
    """Wrap a tuple-input predictor with flip-mirrored averaging.

    ``axes`` are spatial axes of the (B, D, H, W, C) window batch. The
    wrapped predictor calls ``predictor`` once per flip combination (8 for
    three axes), takes the softmax of each output in fp32 when
    ``apply_softmax``, and returns the mean of the un-flipped results."""
    combos = [c for r in range(len(axes) + 1)
              for c in itertools.combinations(axes, r)]

    def wrapped(model_in):
        win, centers, affine = model_in
        acc = None
        for combo in combos:
            out = predictor((torch.flip(win, combo) if combo else win,
                             centers, affine))
            if combo:
                out = torch.flip(out, combo)
            p = out.float()
            if apply_softmax:
                p = torch.softmax(p, dim=-1)
            acc = p if acc is None else acc + p
        return acc / len(combos)

    return wrapped
