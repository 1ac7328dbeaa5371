"""The predictor call's share (%) of the card's bf16 peak: the model FLOPs
of the calls' windows (the forward of one window counted from the plain
reference) over the calls' device time (CUDA events, the window's volumes
outside the profiled sub-window), over 989 TFLOP/s."""

from portbench.readers import calls
from portbench.roofline import PEAK_BF16_FLOPS


def read(rec):
    c = calls(rec)
    if not c or not rec.flops_per_item:
        return None
    flops = rec.flops_per_item * sum(k for _, _, k in c)
    return 100.0 * flops / (sum(ms for ms, _, _ in c) * 1e-3) / PEAK_BF16_FLOPS
