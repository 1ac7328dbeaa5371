"""Device ms of a volume's read-back (the argmax over the classes, the
uint8 cast and the label map's copy to the host): the program's span
``test_model.readback`` (``cli/run_test.py``), the mean over the volumes
the program traced. Layer: the sliding window."""

from medicalsemseg_tpu_torch.utils import profiling


def read(rec):
    if not hasattr(profiling, "spans"):  # a program without its own spans
        return None
    v = [s.ms for s in profiling.spans() if s.name == "test_model.readback"]
    return sum(v) / len(v) if v else None
