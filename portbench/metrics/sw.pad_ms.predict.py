"""Host ms of padding a volume to the bucket multiple (``np.pad`` on the
host): the program's span ``sw.pad`` (``infer/sliding_window.py``
``rank_volumes``), the mean over the volumes the program traced. Layer: the
sliding window."""

from medicalsemseg_tpu_torch.utils import profiling


def read(rec):
    if not hasattr(profiling, "spans"):  # a program without its own spans
        return None
    v = [s.host_ms for s in profiling.spans() if s.name == "sw.pad"]
    return sum(v) / len(v) if v else None
