"""Device ms of a training step's backward less its rematerialisation: the
program's span ``train_step.backward`` (``train/state.py``) less the
``remat.recompute`` spans (``models/layers.py``) that ran inside it; the
median over the steps the program traced. Layer: the train step."""

import statistics
from collections import defaultdict

from medicalsemseg_tpu_torch.utils import profiling


def read(rec):
    if not hasattr(profiling, "spans"):  # a program without its own spans
        return None
    spans = profiling.spans()
    recompute = defaultdict(float)
    for s in spans:
        if s.name == "remat.recompute":
            recompute[s.parent] += s.ms
    v = [s.ms - recompute[s.id] for s in spans
         if s.name == "train_step.backward"]
    return statistics.median(v) if v else None
