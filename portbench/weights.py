"""Seeded weights for a model's parameters, made on the device in a few
large draws: one truncated-normal draw over all random leaves, scaled per
leaf, and the constant leaves filled. The benchmark hands the same dict to
the program and to the reference.

The rule per leaf follows the initialisers the models are trained from:
biases 0; LayerNorm and InstanceNorm scales 1; relative-position bias
tables and dense weights truncated normal(0.02); convolution and transposed
convolution kernels LeCun normal (truncated, variance 1 / fan-in).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# flax's lecun_normal divides by the std of a unit normal truncated to +-2
_TRUNC_STD = 0.87962566103423978


def _std(name: str, shape: Tuple[int, ...]) -> float:
    """The leaf's standard deviation, or 0 for a constant leaf."""
    if len(shape) == 1:
        return 0.0
    if name.endswith("relative_position_bias_table") or len(shape) == 2:
        return 0.02
    k = math.prod(shape[2:])
    fan_in = k * (shape[0] if "transp_conv" in name else shape[1])
    return (1.0 / fan_in) ** 0.5 / _TRUNC_STD


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """fp32 leaves of ``shapes`` (name -> shape, in state_dict order) on
    ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stds = {k: _std(k, s) for k, s in shapes.items()}
    total = sum(math.prod(s) for k, s in shapes.items() if stds[k] > 0)
    flat = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        if stds[k] > 0:
            out[k] = flat[at:at + n].view(s) * stds[k]
            at += n
        elif k.endswith(".bias"):
            out[k] = torch.zeros(s, device=device)
        else:
            out[k] = torch.ones(s, device=device)
    return out
