"""Host ms of copying a padded volume to the card (from pageable host
memory): the program's span ``test_model.h2d`` (``cli/run_test.py``), the
mean over the volumes the program traced. Layer: the sliding window."""

from medicalsemseg_tpu_torch.utils import profiling


def read(rec):
    if not hasattr(profiling, "spans"):  # a program without its own spans
        return None
    v = [s.host_ms for s in profiling.spans() if s.name == "test_model.h2d"]
    return sum(v) / len(v) if v else None
