"""The port's kernels' share (%) of their roofline in prediction: the
summed bound of the K1 and K2 calls of the profiled volumes' predictor
calls (their counts from the port's launch counters, their windows from the
calls' spans, their shapes from the configuration) over the device time of
all the port's kernel launches there."""

from portbench.readers import profiled_calls, say, split_ops
from portbench.roofline import kernels
from portbench.record import reference_module


def read(rec):
    port, _ = split_ops(rec)
    batches = profiled_calls(rec)
    if not port or not batches:
        say("kernels_roofline.predict: no launch of the port's kernels in "
            "the profiled volumes")
        return None
    flags = rec.cell.config["flags"]
    elem = 2 if flags["compute_dtype"] in ("bfloat16", "float16") else 4
    bound = kernels.swin_bound_s(reference_module(rec.cell).stages(flags),
                                 rec.trace["counters"], batches, elem)
    return 100.0 * bound / (sum(us for _, us, _ in port) * 1e-6)
