"""Device ms of the model's forward in a training step, from the program's
own span ``train_step.forward`` (``train/state.py``): the median over the
steps the program traced (the profiled sub-window of a ``--trace 1`` run).
Layer: the train step."""

import statistics

from medicalsemseg_tpu_torch.utils import profiling


def read(rec):
    if not hasattr(profiling, "spans"):  # a program without its own spans
        return None
    v = [s.ms for s in profiling.spans() if s.name == "train_step.forward"]
    return statistics.median(v) if v else None
