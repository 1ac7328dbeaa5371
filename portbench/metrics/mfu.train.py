"""The whole training step's share (%) of the card's bf16 peak: the model
FLOPs of a step (forward and backward of every crop, counted from the plain
reference, no recompute) over the mean time from one step's start to the
next's (CUDA events, the window's steps outside the profiled sub-window),
over 989 TFLOP/s."""

import statistics

from portbench.readers import step_gaps_ms
from portbench.roofline import PEAK_BF16_FLOPS


def read(rec):
    gaps = step_gaps_ms(rec)
    if not gaps or not rec.flops_per_item:
        return None
    flops = rec.flops_per_item * rec.cell.mix["batch"]
    return 100.0 * flops / (statistics.fmean(gaps) * 1e-3) / PEAK_BF16_FLOPS
