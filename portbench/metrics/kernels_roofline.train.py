"""The port's kernels' share (%) of their roofline in training: the summed
bound of the K1-K4 calls of the profiled steps (their counts from the
port's launch counters, their shapes from the configuration) over the
device time of all the port's kernel launches there."""

from portbench.readers import say, split_ops
from portbench.roofline import kernels
from portbench.record import reference_module


def read(rec):
    port, _ = split_ops(rec)
    if not port:
        say("kernels_roofline.train: no launch of the port's kernels in the "
            "profiled steps")
        return None
    flags = rec.cell.config["flags"]
    a, b = rec.profiled
    elem = 2 if flags["compute_dtype"] in ("bfloat16", "float16") else 4
    bound = kernels.swin_bound_s(reference_module(rec.cell).stages(flags),
                                 rec.trace["counters"],
                                 [rec.cell.mix["batch"]] * (b - a), elem)
    return 100.0 * bound / (sum(us for _, us, _ in port) * 1e-6)
