"""Device ms a training step spends in kernel K11 (``csrc/instance_norm.cu``:
the UNETR decoder's InstanceNorm -> residual -> LeakyReLU chain, its
forward, the forward again in a rematerialised block's recompute, and its
backward): the device time of K11's kernels, found by name among the
profiled sub-window's device ops, over the profiled steps. The device's
own time, so host waits inside the wrapper do not count. A trace without
K11's kernels (a program without K11) reads None. Layer: the kernels."""

# K11's kernels (csrc/instance_norm.cu), as the trace names them
KERNELS = ("instance_norm_stats_kernel", "instance_norm_merge_kernel",
           "instance_norm_act_kernel", "instance_norm_bwd_reduce_kernel",
           "instance_norm_bwd_finish_kernel", "instance_norm_bwd_apply_kernel")


def read(rec):
    ops = rec.trace["ops"] if rec.trace else []
    us = [u for name, u, _ in ops if any(k in name for k in KERNELS)]
    a, b = rec.profiled
    if not us or b <= a:
        return None
    return sum(us) / 1e3 / (b - a)
