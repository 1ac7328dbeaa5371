"""Metric smoothing and iteration logging.

Equivalents of the reference's SmoothedValue / MetricLogger
(reference: utils/misc.py:16-178): windowed medians/averages, global
averages, per-iteration timing with ETA. Copy of
medicalsemseg_tpu/utils/logger.py; under ``torch.distributed`` the
cross-process synchronisation is an fp64 all_reduce of [count, total], the
reference's; in one process it is a no-op.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np


class SmoothedValue:
    """Track a series with a smoothing window and global statistics."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self, group=None):
        """Sum [count, total] over the processes of ``group`` (default: the
        world), the reference's fp64 all_reduce (utils/misc.py:34-45).
        Every rank of the group calls it for the same meters in the same
        order."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size(group) == 1:
            return
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t, group=group)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is None or (isinstance(v, float) and np.isnan(v)):
                continue
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def synchronize_between_processes(self, group=None):
        for m in self.meters.values():
            m.synchronize_between_processes(group)

    def log_all_average(self) -> str:
        return self.delimiter.join(
            f"{name}: {m.global_avg:.4f}" for name, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None):
        """Yield items while printing iter/data times and ETA
        (reference: utils/misc.py:134-178)."""
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        if total is None:
            total = len(iterable) if hasattr(iterable, "__len__") else None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                eta = ""
                if total:
                    eta_s = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
                meters = self.delimiter.join(
                    f"{name}: {m}" for name, m in self.meters.items())
                print(f"{header} [{i}{'/' + str(total) if total else ''}]  "
                      f"{eta}{meters}  time: {iter_time}  data: {data_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))}")
