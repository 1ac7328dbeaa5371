"""Device ms of a training step's update (the gradient's norm, the clip,
AdamW, zeroing the gradients): the program's span ``train_step.update``
(``train/state.py``), the median over the steps the program traced. Layer:
the train step."""

import statistics

from medicalsemseg_tpu_torch.utils import profiling


def read(rec):
    if not hasattr(profiling, "spans"):  # a program without its own spans
        return None
    v = [s.ms for s in profiling.spans() if s.name == "train_step.update"]
    return statistics.median(v) if v else None
