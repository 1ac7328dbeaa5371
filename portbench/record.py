"""What a run hands its per-layer readers, and the pieces of the result
line that every traffic generator fills the same way."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

import torch

from portbench import profiled


@dataclasses.dataclass
class Record:
    """A ``--trace 1`` run as the metric readers see it.

    ``spans``: name -> [(ms, tag)] of CUDA-event spans (``body``: a train
    step's call, ``fwd``: the model's forward, ``call``: a predictor call,
    tag its windows), ``step.gap``: ms from one step's start to the next's;
    ``host``: name -> [seconds] of host-clock spans (``volume``: a volume
    through ``test_model``); ``profiled``: the steps or volumes [a, b) of
    the window that the profiler saw; ``trace``: the profiled sub-window
    (``profiled.reduce_trace``) with the port's launch counters over it;
    ``flops_per_item``: model FLOPs of one crop (forward and backward) or
    one window (forward)."""

    kind: str
    cell: object
    spans: Dict[str, List[Tuple[float, object]]]
    host: Dict[str, List[float]]
    profiled: Tuple[int, int]
    trace: Optional[Dict]
    flops_per_item: float = 0.0


def argv(flags: Dict, extra: Dict) -> List[str]:
    """The port's command-line flags of a configuration."""
    out = []
    for k, v in {**flags, **extra}.items():
        if isinstance(v, bool):
            if v:
                out.append("--" + k)
        elif isinstance(v, (list, tuple)):
            out += ["--" + k] + [str(x) for x in v]
        else:
            out += ["--" + k, str(v)]
    return out


def reference_module(cell):
    return importlib.import_module("portbench.reference."
                                   + cell.config["reference"])


def launch_counts() -> Dict[str, int]:
    """The port's own counters of its kernel calls: K1 and K2 by their
    wrappers' route counts, K3 and K4 by their backward counts."""
    from medicalsemseg_tpu_torch.ops.kernels import mlp
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as wa

    return {"K1": sum(wa.route_launches.values()), "K3": wa.bwd_launches,
            "K2": sum(mlp.route_launches.values()), "K4": mlp.bwd_launches}


def model_flops(cell, shapes, crop, train: bool) -> float:
    from portbench.roofline.model_flops import model_flops as count

    return count(reference_module(cell).forward, cell.config["flags"],
                 shapes, crop, train)


def device_fields(device, peak: int, summary: Optional[Dict]) -> Dict:
    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if summary is not None:
        out["busy_s"] = summary["busy_s"]
        out["window_s"] = summary["window_s"]
    return out


def breakdown(summary: Optional[Dict]) -> Optional[Dict]:
    if summary is None:
        return None
    return {"device_ops": profiled.top([(n[:160], us * 1e-6)
                                        for n, us, _ in summary["ops"]]),
            "idle_gaps": profiled.top([(n[:160], s)
                                       for s, n in summary["gaps"]])}
