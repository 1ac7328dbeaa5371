"""What the per-layer readers (``portbench/metrics/<metric>.py``) share:
the spans of a ``--trace 1`` run outside its profiled sub-window, and the
sub-window's device ops split into the port's kernels and the libraries'."""

from __future__ import annotations

import sys
from typing import List, Tuple

from portbench.roofline import kernels


def outside(rec, i: int) -> bool:
    """Whether step or volume ``i`` ran outside the profiled sub-window
    (and the synchronises at its ends)."""
    a, b = rec.profiled
    return not (a - 1 <= i <= b)


def step_gaps_ms(rec) -> List[float]:
    """ms from each step's start to the next's, outside the sub-window."""
    return [ms for i, (ms, _) in enumerate(rec.spans.get("step.gap", []))
            if outside(rec, i)]


def calls(rec) -> List[Tuple[float, int, int]]:
    """(ms, volume, windows) of every predictor call outside the
    sub-window."""
    return [(ms, v, k) for ms, (v, k) in rec.spans.get("call", [])
            if outside(rec, v)]


def profiled_calls(rec) -> List[int]:
    """Windows of each predictor call inside the sub-window."""
    a, b = rec.profiled
    return [k for _, (v, k) in rec.spans.get("call", []) if a <= v < b]


def split_ops(rec):
    """(the port's ops, the libraries' ops) of the sub-window, each as
    (name, us, inside a model call)."""
    ops = rec.trace["ops"] if rec.trace else []
    port = [o for o in ops if kernels.family(o[0])]
    return port, [o for o in ops if not kernels.family(o[0])]


def say(text: str) -> None:
    print(f"portbench: {text}", file=sys.stderr)
