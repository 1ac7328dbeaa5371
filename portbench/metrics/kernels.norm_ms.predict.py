"""Device ms a predictor call spends in kernel K11 (``csrc/instance_norm.cu``:
the UNETR decoder's InstanceNorm -> residual -> LeakyReLU chain, or its
statistics alone in the fused decoder): the device time of K11's kernels,
found by name among the device ops launched inside the model's calls of
the profiled volumes, per call. The device's own time, so host waits inside
the wrapper do not count. A trace without K11's kernels (a program without
K11) reads None. Layer: the kernels."""

from portbench.readers import profiled_calls

# K11's forward kernels (csrc/instance_norm.cu), as the trace names them
KERNELS = ("instance_norm_stats_kernel", "instance_norm_merge_kernel",
           "instance_norm_act_kernel")


def read(rec):
    ops = rec.trace["ops"] if rec.trace else []
    us = [u for name, u, in_model in ops
          if in_model and any(k in name for k in KERNELS)]
    n = len(profiled_calls(rec))
    if not us or not n:
        return None
    return sum(us) / 1e3 / n
