"""Tracing, profiling and debugging hooks (counterpart of
medicalsemseg_tpu/utils/profiling.py).

  * :func:`trace` — ``torch.profiler`` with CPU and (where there is a card)
    CUDA activities around a region; writes a Chrome trace
    ``trace_rank{r}.json`` into the directory (open it in Perfetto or
    chrome://tracing: the GPU rows hold the kernels under their
    ``__global__`` names, the CPU rows the ops that launched them);
  * :func:`annotate` — a named region (``record_function``) in that trace;
  * :func:`enable_anomaly_detection` — ``torch.autograd.set_detect_anomaly``
    (the ``--anomaly_detection`` flag);
  * :func:`device_memory_stats` — bytes in use and the peak per CUDA
    device (``torch.cuda.memory_stats``), ``{}`` on the CPU.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """Trace the region into ``log_dir`` (nothing when it is None); yields
    the path of the trace file it will write."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    from medicalsemseg_tpu_torch.parallel.dist import get_rank

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_rank{get_rank()}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    print(f"profile: wrote {path}")


def annotate(name: str):
    """Named region that shows up in the trace."""
    return torch.profiler.record_function(name)


def enable_anomaly_detection(enable: bool = True) -> None:
    """Raise at the backward op that makes a NaN (--anomaly_detection)."""
    torch.autograd.set_detect_anomaly(enable)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{'cuda:i': {'bytes_in_use', 'peak_bytes_in_use'}} per CUDA device
    this process has used; {} where there is none."""
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        if not torch.cuda.is_initialized():
            break
        stats = torch.cuda.memory_stats(i)
        if stats:
            out[f"cuda:{i}"] = {
                "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                              0)),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                                   0)),
            }
    return out
