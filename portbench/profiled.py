"""The spans and the device trace of a ``--trace 1`` run.

:class:`Spans` records CUDA events around the calls into the program's
layers (the train step, the model's forward); it reads them once the window
has closed. :class:`SubWindow` runs
``torch.profiler`` over a short sub-window of whole steps or volumes and
reduces its trace to what the per-layer readers take: the device's busy
time in the sub-window, its kernels by name, and the idle gaps named by
what the host was doing.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

# a kernel or copy on the device, in the profiler's chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"
MODEL = "portbench.model"


class Spans:
    """Named CUDA-event spans of one run."""

    def __init__(self, on: bool):
        self.on = on
        self.events: Dict[str, List[Tuple]] = defaultdict(list)
        self.marks: Dict[str, List[torch.cuda.Event]] = defaultdict(list)

    def mark(self, name: str) -> None:
        """An event at this point of the stream (a step's start)."""
        if self.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks[name].append(e)

    def begin(self):
        """An event that a later :meth:`end` closes into a span."""
        if not self.on:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def end(self, name: str, start, tag=None) -> None:
        if start is None:
            return
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events[name].append((start, e, tag))

    def read(self) -> Dict[str, List[Tuple[float, object]]]:
        """(ms, tag) of every span, and the ms between consecutive marks
        (under ``<name>.gap``); call once the window has closed."""
        torch.cuda.synchronize()
        out = {k: [(a.elapsed_time(b), tag) for a, b, tag in v]
               for k, v in self.events.items()}
        for k, v in self.marks.items():
            out[k + ".gap"] = [(a.elapsed_time(b), None)
                               for a, b in zip(v, v[1:])]
        return out


class SubWindow:
    """``torch.profiler`` (CPU and CUDA activity) between :meth:`start` and
    :meth:`stop`, each behind a synchronise, the span annotated as
    ``portbench.window``; the model's calls in it as ``portbench.model``
    (:meth:`model_call`). ``counters()``, where given, is read at both
    ends and the difference kept in the summary's ``counters``."""

    def __init__(self, counters=None, outside: str = "host"):
        self.counters, self.outside = counters, outside
        self.prof = None
        self.summary: Optional[Dict] = None
        self.active = False

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.rf = torch.profiler.record_function(WINDOW)
        self.rf.__enter__()
        self.active = True
        self.c0 = self.counters() if self.counters else {}

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.active = False
        c1 = self.counters() if self.counters else {}
        self.counted = {k: c1[k] - self.c0[k] for k in c1}

    def reduce(self) -> None:
        """Read the trace of the stopped sub-window into ``summary``; call
        once the window has closed (the export takes seconds)."""
        if self.prof is None:
            return
        t = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        self.summary = reduce_trace(trace.get("traceEvents", trace),
                                    self.outside)
        self.summary["read_s"] = time.perf_counter() - t
        self.summary["counters"] = self.counted

    def span(self, name: str):
        """A context that annotates a call of the program while profiling
        (the idle gaps are named by the innermost one)."""
        if self.active:
            return torch.profiler.record_function(name)
        return _NULL

    def model_call(self):
        """A context that annotates one model call while profiling."""
        return self.span(MODEL)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(events: List[Dict], outside: str = "host") -> Dict:
    """The sub-window's device activity from a chrome trace: its length
    (``window_s``, the ``portbench.window`` annotation), the time the
    device was busy in it (``busy_s``, the union of its kernels and
    copies), every device op as (name, us, launched inside a model call),
    and the idle gaps (``gaps``: (seconds, what the host's main thread was
    running at the gap's start, ``outside`` where it ran none of the
    annotated calls or ops))."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the profiled trace has no portbench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main_tid = win[0].get("tid")
    model = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X"
                   and e.get("name") == MODEL
                   and e.get("cat") == "user_annotation")
    model_starts = [a for a, _ in model]
    launch_ts = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])

    def in_model(corr) -> bool:
        ts = launch_ts.get(corr)
        if ts is None:
            return False
        i = bisect.bisect_right(model_starts, ts) - 1
        return i >= 0 and ts <= model[i][1]

    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        ops.append((e["name"], b - a,
                    in_model((e.get("args") or {}).get("correlation"))))
        spans.append((a, b))
    busy = _union(spans)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("tid") == main_tid
                  and e.get("cat") in ("cpu_op", "user_annotation")
                  and e.get("name") != WINDOW)
    gaps = []
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append(((b - a) * 1e-6, _host_at(host, a, outside)))
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "ops": ops, "gaps": gaps}


def _host_at(host: List[Tuple[float, float, str]], t: float,
             outside: str) -> str:
    """The innermost host span of the main thread running at ``t``."""
    name, start = outside, -1.0
    i = bisect.bisect_right(host, (t, float("inf"), ""))
    for a, b, n in reversed(host[max(0, i - 2000):i]):
        if a <= t <= b and a > start:
            name, start = n, a
    return name


def top(pairs: List[Tuple[str, float]], n: int = 10) -> List[List]:
    """The n names with the most seconds, summed by name."""
    acc: Dict[str, float] = defaultdict(float)
    for k, v in pairs:
        acc[k] += v
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]
