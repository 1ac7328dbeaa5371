"""The comparisons that decide ``correct``.

Each number is compared with its limit from the cell's file
(``workloads/<cell>.json`` ``limits``); a number is within it when it is
at most the limit.

Training (the first three steps against the reference's):

* ``loss``: the largest relative gap of a step's loss;
* ``grad``: the first gradient as the optimizer got it (worked out from its
  first moment after one step), by the worst leaf: the gap between the
  program's norm of the leaf and the reference's, over the reference's
  norm of that leaf or of the median leaf, whichever is larger (read and
  printed; not compared where the cell gives it no limit: neither the
  control nor a fault reads three times the sound runs on it);
* ``update``: the parameters' change after the three steps, by the worst
  leaf, measured the same way; leaves whose reference gradient is under a
  thousandth of the median leaf's are left out (they move under AdamW by
  round-off alone, as a key's bias does under softmax).

Prediction: ``label_gap``, the widest gap by which the logit of a label
the program put out lies below the best logit of the reference, over every
voxel of a sample of the window's volumes.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Optional

SMALL_GRAD = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[List[str]] = None) -> float:
    """The worst leaf's gap of norms, over max(its norm, the median's)."""
    names = list(ref) if keep is None else keep
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def train_numbers(losses: List[float], first_grad: Dict[str, float],
                  delta: Dict[str, float], ref: Dict) -> Dict[str, float]:
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    g_med = statistics.median(ref["first_grad"].values())
    moving = [k for k, v in ref["first_grad"].items()
              if v >= SMALL_GRAD * g_med]
    return {"loss": loss,
            "grad": leaf_gap(first_grad, ref["first_grad"]),
            "update": leaf_gap(delta, ref["delta"], moving)}


def with_limits(numbers: Dict[str, float], limits: Dict) -> Dict[str, Dict]:
    """Each number that the cell's file gives a limit, beside it. A number
    it leaves out is not compared (``grad``: see ``PERF.md`` §4) and is
    printed on an earlier line of standard error."""
    for k, v in numbers.items():
        if k not in limits:
            print(f"portbench: not compared: {k} {v!r}", file=sys.stderr)
    return {k: {"value": numbers[k], "limit": limits[k]["limit"]}
            for k in limits}
