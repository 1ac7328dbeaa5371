"""The benchmark's harness: finds a cell's files by the names in
``BENCHMARK.json``, runs it, and prints the result.

Files, each found by name, none listed here:

* ``portbench/workloads/<cell>.json``: the cell's limits of the comparison
  that decides ``correct`` (and the readings they were set from);
* ``portbench/configs/<config>.json``: the port's flags of the
  configuration (``flags``), its ``source``, ``assumed``, ``reduced`` and
  ``departs`` (keys the program forces away from the source), and the
  module of its plain reference (``reference``, under
  ``portbench/reference/``);
* ``portbench/traffic/<traffic>.json``: the traffic mix's parameters, with
  the generator that reads them (``kind``: ``portbench/traffic/<kind>.py``);
* ``portbench/metrics/<metric>.py``: one reader per per-layer metric,
  ``read(record) -> float | None``.

The result is the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# what no process of the benchmark may load: JAX and the JAX package, by
# top-level name (the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "medicalsemseg_tpu")


def parse_args(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="portbench: one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", required=True, type=int, choices=(0, 1))
    args = p.parse_args(argv)
    if args.seconds <= 0:
        p.error("--seconds must be positive")
    if args.seed < 0:
        p.error("--seed must not be negative")
    return args


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: Optional[str] = None):
    """A module of the benchmark by its file (names may hold dots), loaded
    once a process."""
    name = name or "portbench_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def traffic_path(cell: "Cell", root: str = ROOT) -> str:
    """The file of the generator that reads the cell's traffic mix."""
    return os.path.join(root, "portbench", "traffic", cell.mix["kind"] + ".py")


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Cell:
    """Everything one run of a cell reads, by name."""

    name: str
    entry: Dict            # the cell's entry in BENCHMARK.json
    config: Dict           # configs/<config>.json
    mix: Dict              # traffic/<traffic>.json
    limits: Dict           # workloads/<cell>.json "limits"
    end_to_end: List[Dict]
    per_layer: List[Dict]


def find_cell(bench: Dict, name: str, root: str = ROOT) -> Cell:
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    here = os.path.join(root, "portbench")
    config = load_json(here, "configs", entry["config"] + ".json")
    mix = load_json(here, "traffic", entry["traffic"] + ".json")
    cell = load_json(here, "workloads", name + ".json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name, entry, config, mix, cell.get("limits", {}), e2e, layer)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, root: str = ROOT) -> Dict:
    """Run one cell on ``device`` (the measuring path gives a card; the
    harness tests a CPU) and return the result's fields."""
    for k in [k for k in os.environ if k.startswith("MEDSEG_")]:
        del os.environ[k]
    os.environ.update(cell.config.get("env", {}))
    gen = load_module(traffic_path(cell, root))
    out = gen.run(cell, seed=seed, seconds=seconds, trace=trace,
                  device=device, t0=t0)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            reader = load_module(os.path.join(root, "portbench", "metrics",
                                              m["name"] + ".py"))
            v = reader.read(out["record"])
            if v is None:
                print(f"portbench: {m['name']}: nothing to read in this run",
                      file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in out["end_to_end"]:
                raise RuntimeError(f"{cell.name} does not report {m['name']}")
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    checks = out["checks"]
    correct = bool(checks) and out["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return result


def main(argv: List[str], t0: float) -> int:
    args = parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is false; this benchmark "
              "measures a GPU and does not fall back to the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; the benchmark "
              "may not load JAX or the JAX package", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: Dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
