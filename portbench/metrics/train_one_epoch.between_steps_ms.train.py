"""Host ms between training steps in ``train_one_epoch``
(``train/loop.py``): from the end of one ``train_step`` span to the start of
the next (the loader, the metric window, the read-back, logging), the mean
over the consecutive steps the program traced. Layer: the train step."""

from medicalsemseg_tpu_torch.utils import profiling


def read(rec):
    if not hasattr(profiling, "spans"):  # a program without its own spans
        return None
    steps = sorted((s for s in profiling.spans() if s.name == "train_step"),
                   key=lambda s: s.t0_ns)
    gaps = [(b.t0_ns - a.t1_ns) * 1e-6 for a, b in zip(steps, steps[1:])]
    return sum(gaps) / len(gaps) if gaps else None
