"""Device ms a training step spends in kernels that are not the port's
(cuDNN, cuBLAS, PyTorch's elementwise and reduction kernels), over the
profiled steps."""

from portbench.readers import split_ops


def read(rec):
    _, lib = split_ops(rec)
    a, b = rec.profiled
    if not lib or b <= a:
        return None
    return sum(us for _, us, _ in lib) / 1e3 / (b - a)
