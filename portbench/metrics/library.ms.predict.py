"""Device ms a predictor call spends in kernels that are not the port's
(cuDNN, cuBLAS, PyTorch's kernels), counting the kernels launched inside
the model's calls of the profiled volumes, per call."""

from portbench.readers import profiled_calls, split_ops


def read(rec):
    _, lib = split_ops(rec)
    n = len(profiled_calls(rec))
    inside = [us for _, us, in_model in lib if in_model]
    if not n or not inside:
        return None
    return sum(inside) / 1e3 / n
