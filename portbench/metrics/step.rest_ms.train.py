"""Device ms of a training step after the model's forward (the loss, the
backward with its recompute, AdamW, the step's Dice): the step call's
CUDA-event span less its forward's, the median over the window's steps
outside the profiled sub-window."""

import statistics

from portbench.readers import outside


def read(rec):
    fwd = {i: ms for ms, i in rec.spans.get("fwd", [])}
    v = [ms - fwd[i] for ms, i in rec.spans.get("body", [])
         if outside(rec, i) and i in fwd]
    return statistics.median(v) if v else None
