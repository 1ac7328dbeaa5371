"""Device ms of blending a full call's windows into the volume (the
Gaussian-weighted indexed adds of the output and the counts): the program's
span ``sw.blend`` (``infer/sliding_window.py``) of the calls of the mix's
full ``windows_per_call``, the median over those the program traced. Layer:
the sliding window."""

import statistics

from medicalsemseg_tpu_torch.utils import profiling


def read(rec):
    if not hasattr(profiling, "spans"):  # a program without its own spans
        return None
    full = rec.cell.mix["windows_per_call"]
    v = [s.ms for s in profiling.spans() if s.name == "sw.blend"
         and s.attrs.get("windows") == full]
    return statistics.median(v) if v else None
