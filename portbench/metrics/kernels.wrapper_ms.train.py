"""Device ms of the K1-K4 wrappers in a training step: the program's spans
``K1`` to ``K4`` (the forward and backward of ``WindowAttentionFn`` and
``FusedMlpFn``, ``ops/kernels/``: the launches with the casts and copies
around them, in the forward and the recompute) summed by step (their unit,
``state.step``); the median over the steps the program traced. Layer: the
kernels."""

import statistics
from collections import defaultdict

from medicalsemseg_tpu_torch.utils import profiling

KERNELS = ("K1", "K2", "K3", "K4")


def read(rec):
    if not hasattr(profiling, "spans"):  # a program without its own spans
        return None
    by_step = defaultdict(float)
    for s in profiling.spans():
        if s.name in KERNELS:
            by_step[s.unit] += s.ms
    return statistics.median(by_step.values()) if by_step else None
