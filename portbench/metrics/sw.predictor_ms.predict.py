"""Device ms of a predictor call of the mix's full ``windows_per_call``:
the program's span ``sw.predictor`` (``infer/sliding_window.py``; the
model's call on a stack of windows), the median over the full calls the
program traced. Layer: the model."""

import statistics

from medicalsemseg_tpu_torch.utils import profiling


def read(rec):
    if not hasattr(profiling, "spans"):  # a program without its own spans
        return None
    full = rec.cell.mix["windows_per_call"]
    v = [s.ms for s in profiling.spans() if s.name == "sw.predictor"
         and s.attrs.get("windows") == full]
    return statistics.median(v) if v else None
