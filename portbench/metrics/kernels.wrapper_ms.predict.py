"""Device ms of the K1 and K2 wrappers in a predictor call of the mix's full
``windows_per_call``: the program's spans ``K1`` and ``K2``
(``ops/kernels/``: the launches with the casts and copies around them)
summed by the ``sw.predictor`` span they ran in; the median over the full
calls the program traced. Layer: the kernels."""

import statistics
from collections import defaultdict

from medicalsemseg_tpu_torch.utils import profiling


def read(rec):
    if not hasattr(profiling, "spans"):  # a program without its own spans
        return None
    spans = profiling.spans()
    full = rec.cell.mix["windows_per_call"]
    calls = {s.id for s in spans if s.name == "sw.predictor"
             and s.attrs.get("windows") == full}
    by_call = defaultdict(float)
    for s in spans:
        if s.name in ("K1", "K2") and s.parent in calls:
            by_call[s.parent] += s.ms
    return statistics.median(by_call.values()) if by_call else None
