"""Tracing, profiling and debugging hooks (counterpart of
medicalsemseg_tpu/utils/profiling.py).

  * :func:`trace` — ``torch.profiler`` with CPU and (where there is a card)
    CUDA activities around a region; writes a Chrome trace
    ``trace_rank{r}.json`` into the directory (open it in Perfetto or
    chrome://tracing: the GPU rows hold the kernels under their
    ``__global__`` names, the CPU rows the ops that launched them and the
    program's spans);
  * :func:`span` — the program's span: a named region of the train step,
    the prediction loop or a kernel wrapper, recorded while tracing is on;
    :func:`spans` reads the recorded ones;
  * :func:`enable_anomaly_detection` — ``torch.autograd.set_detect_anomaly``
    (the ``--anomaly_detection`` flag);
  * :func:`device_memory_stats` — bytes in use and the peak per CUDA
    device (``torch.cuda.memory_stats``), ``{}`` on the CPU.

Tracing is on while a ``torch.profiler`` profile runs (so every
``--profile_dir`` trace holds the spans) and between :func:`enable` and
:func:`disable`; otherwise :func:`span` costs one flag check and returns a
shared context that does nothing. A span records its name, an id, the span
it ran inside, the unit (request) it belongs to, its host start and end on
``time.time_ns()`` (the clock of the profiler's Chrome trace: an event's
``ts`` in microseconds plus the trace's ``baseTimeNanoseconds``), on a card
a pair of CUDA events on the current stream, and its attributes. While the
profiler runs it is also a ``record_function`` of the same name, so the
trace shows it beside the ops and kernels it launched. Finished spans go to
a buffer of :data:`CAPACITY`; the oldest are dropped beyond it and counted
(:func:`dropped`).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _prof

# finished spans kept; the oldest are dropped beyond it
CAPACITY = 65536

_enabled = False
_done: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_main_stack: Optional[List["Span"]] = None


class _Stack(threading.local):
    """The open spans of one thread, innermost last."""

    def __init__(self):
        global _main_stack
        self.open: List[Span] = []
        if threading.current_thread() is threading.main_thread():
            _main_stack = self.open


_tls = _Stack()


def tracing() -> bool:
    """Whether spans are recorded now: while ``torch.profiler`` runs, or
    between :func:`enable` and :func:`disable`."""
    return _enabled or _prof._is_profiler_enabled


def enable() -> None:
    """Record spans from now on, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler runs (the default)."""
    global _enabled
    _enabled = False


class Span:
    """One span; a context manager while open, a record once finished.

    ``id``; ``parent``: the id of the span it ran inside, or None (a span
    that opens on a thread with none open, as on autograd's backward
    threads, runs inside the main thread's innermost); ``unit``: the
    request it belongs to (the train step's ``state.step``, the volume's
    index in ``rank_volumes``), inherited from its parent unless given;
    ``t0_ns``, ``t1_ns``: host start and end on ``time.time_ns()``;
    ``device_ms``: the time between its CUDA events, filled by
    :func:`spans` (None where CUDA is not in use); ``attrs``, with
    ``raised`` the name of an exception that left it."""

    __slots__ = ("name", "id", "parent", "unit", "t0_ns", "t1_ns",
                 "device_ms", "attrs", "_events", "_rf", "_stack")

    def __init__(self, name: str, unit=None, attrs: Optional[Dict] = None):
        self.name, self.unit = name, unit
        self.attrs = attrs if attrs is not None else {}
        self.id = next(_ids)
        self.parent = None
        self.t0_ns = self.t1_ns = 0
        self.device_ms: Optional[float] = None
        self._events = self._rf = None

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6

    @property
    def ms(self) -> float:
        """Device ms where the span ran with CUDA in use, host ms else."""
        return self.device_ms if self.device_ms is not None else self.host_ms

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _tls.open
        outer = stack[-1] if stack else (
            _main_stack[-1] if _main_stack else None)
        if outer is not None:
            self.parent = outer.id
            if self.unit is None:
                self.unit = outer.unit
        stack.append(self)
        self._stack = stack
        self.t0_ns = time.time_ns()
        if _prof._is_profiler_enabled:
            self._rf = _prof.record_function(self.name)
            self._rf.__enter__()
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _dropped
        if self._events is not None:
            self._events[1].record()
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
            self._rf = None
        self.t1_ns = time.time_ns()
        if exc_type is not None:
            self.attrs["raised"] = exc_type.__name__
        self._stack.remove(self)
        self._stack = None
        with _lock:
            if len(_done) == _done.maxlen:
                _dropped += 1
            _done.append(self)
        return False


class _Off:
    """What :func:`span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, unit=None, **attrs):
    """A span named ``name`` around a ``with`` block while tracing is on
    (:func:`tracing`), a shared context that does nothing while it is off.
    ``unit`` is the id of the request the span starts (its children inherit
    it); ``attrs`` are kept with it, and ``.set(**attrs)`` on the context
    adds more inside the block."""
    if not (_enabled or _prof._is_profiler_enabled):
        return _OFF
    return Span(name, unit, attrs)


def spanned(name: str) -> Callable:
    """Decorator form of :func:`span`: every call of the function is a span
    named ``name`` while tracing is on, unless it runs directly inside a
    span of that name (a kernel's autograd function calling its wrapper),
    which it is then part of."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not (_enabled or _prof._is_profiler_enabled) or (
                    _tls.open and _tls.open[-1].name == name):
                return fn(*args, **kwargs)
            with Span(name):
                return fn(*args, **kwargs)
        return inner

    return wrap


def tag(key: str, value) -> None:
    """Set attribute ``key`` of this thread's innermost open span, if any
    (the launch registry tags a kernel wrapper's span with its route)."""
    if _tls.open:
        _tls.open[-1].attrs[key] = value


def spans() -> List[Span]:
    """The finished spans in the buffer, oldest first, with their device
    ms (one synchronise, where any span recorded CUDA events)."""
    with _lock:
        out = list(_done)
    pending = [s for s in out if s._events is not None]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            s._events = None
    return out


def dropped() -> int:
    """Spans dropped from the full buffer since the last :func:`reset`."""
    return _dropped


def reset() -> None:
    """Empty the buffer and zero the dropped count."""
    global _dropped
    with _lock:
        _done.clear()
        _dropped = 0


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
