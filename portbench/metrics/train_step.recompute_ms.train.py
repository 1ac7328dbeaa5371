"""Device ms a training step spends recomputing its checkpointed blocks
(``--remat``): the program's ``remat.recompute`` spans
(``models/layers.py``) summed by step (their unit, ``state.step``); the
median over the steps the program traced. None where no block was
recomputed. Layer: the train step."""

import statistics
from collections import defaultdict

from medicalsemseg_tpu_torch.utils import profiling


def read(rec):
    if not hasattr(profiling, "spans"):  # a program without its own spans
        return None
    by_step = defaultdict(float)
    for s in profiling.spans():
        if s.name == "remat.recompute":
            by_step[s.unit] += s.ms
    return statistics.median(by_step.values()) if by_step else None
