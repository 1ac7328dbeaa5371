"""Device ms of a predictor call of the mix's full size (16 windows): CUDA
events around the model's call, the median over the window's volumes
outside the profiled sub-window."""

import statistics

from portbench.readers import calls


def read(rec):
    full = rec.cell.mix["windows_per_call"]
    v = [ms for ms, _, k in calls(rec) if k == full]
    return statistics.median(v) if v else None
