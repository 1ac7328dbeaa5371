"""Model FLOPs counted from the plain reference with
``torch.utils.flop_counter.FlopCounterMode`` on the meta device (shapes
only, nothing computed): the forward of one crop for prediction, its
forward and backward (every parameter's gradient, the input's none, no
recompute) for training. The count is of the work the model needs, whatever
implements it."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


def model_flops(forward, flags: Dict, shapes: Dict[str, Tuple[int, ...]],
                crop: Sequence[int], train: bool) -> float:
    """FLOPs of one crop (1, *crop, 1) through ``forward(P, flags, vol)``."""
    with torch.device("meta"):
        P = {k: torch.empty(s, requires_grad=train) for k, s in shapes.items()}
        vol = torch.empty(1, *crop, int(flags.get("in_chans", 1)))
    with FlopCounterMode(display=False) as counter:
        out = forward(P, flags, vol)
        if train:
            out.sum().backward()
    return float(counter.get_total_flops())
