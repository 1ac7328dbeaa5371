"""Device ms of the model's forward in a training step (CUDA events around
the model's call), the median over the window's steps outside the profiled
sub-window. Layer: the train step's forward (train/state.py, models/*)."""

import statistics

from portbench.readers import outside


def read(rec):
    v = [ms for ms, i in rec.spans.get("fwd", []) if outside(rec, i)]
    return statistics.median(v) if v else None
