"""The harness on the CPU: its arguments, its last line, a cell added as
files and entries only, the refusal to measure without a card, and what its
processes load."""

from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest
import torch

from portbench import harness, profiled
from portbench.tests.conftest import ROOT, SEED, small_cell

CELLS = ["nnformer_unetr.train.b8", "nnformer_unetr.predict.ct4",
         "swin_unetr.train.b8", "swin_unetr.predict.ct4"]


def test_parse_args():
    a = harness.parse_args(["--workload", "x", "--seed", str(2 ** 33 + 7),
                            "--seconds", "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("x", 2 ** 33 + 7,
                                                        10.0, 1)
    for bad in (["--workload", "x", "--seed", "1", "--seconds", "0",
                 "--trace", "0"],
                ["--workload", "x", "--seed", "1", "--seconds", "5",
                 "--trace", "2"],
                ["--workload", "x", "--seconds", "5", "--trace", "0"]):
        with pytest.raises(SystemExit):
            harness.parse_args(bad)


def test_every_cell_found_by_name():
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    for name in CELLS:
        cell = harness.find_cell(bench, name)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_gib"}
        assert cell.per_layer
        assert os.path.exists(harness.traffic_path(cell))
        for m in cell.per_layer:
            assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                               m["name"] + ".py"))


@pytest.fixture(scope="module")
def train_result():
    cell = small_cell("nnformer_unetr.train.b8")
    return harness.run_cell(cell, SEED, 1.0, False, torch.device("cpu"),
                            time.perf_counter())


def test_last_line_is_the_result(train_result):
    out = io.StringIO()
    with redirect_stdout(out):
        print("the program's own output")
        harness.emit(train_result)
    last = json.loads(out.getvalue().splitlines()[-1])
    assert list(last)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    assert set(last["metrics"]) == {"train_crops_per_s", "peak_gib",
                                    "setup_s"}
    assert last["correct"] is True and last["attempted"] >= 1
    for c in last["checks"].values():
        assert set(c) == {"value", "limit"}


def test_a_cell_added_as_files_is_found(tmp_path):
    """A later cell adds a workload entry and its own files; no file that
    is there changes."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    bench["workloads"].append({
        "name": "nnformer_unetr.train.b2", "config": "nnformer_unetr",
        "traffic": "train.b2", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "nnformer_unetr.train.b8" in m.get("workloads", []):
            m["workloads"].append("nnformer_unetr.train.b2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = harness.load_json(ROOT, "portbench", "traffic", "train.b8.json")
    (tmp_path / "portbench" / "traffic" / "train.b2.json").write_text(
        json.dumps({**mix, "batch": 2}))
    (tmp_path / "portbench" / "workloads" / "nnformer_unetr.train.b2.json"
     ).write_text(json.dumps({"limits": {}}))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file() and "b2" not in p.name}
    cell = harness.find_cell(bench, "nnformer_unetr.train.b2", str(tmp_path))
    assert cell.mix["batch"] == 2
    assert {m["name"] for m in cell.end_to_end} == {
        "train_crops_per_s", "peak_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} >= {"step.fwd_ms.train"}
    small = small_cell("nnformer_unetr.train.b8")
    cell = dataclasses.replace(cell, config=small.config,
                               mix={**small.mix, "batch": 2})
    out = harness.run_cell(cell, SEED, 0.5, False, torch.device("cpu"),
                           time.perf_counter(), root=str(tmp_path))
    assert out["attempted"] >= 1
    assert before == {p: p.read_bytes() for p in before}


def test_no_card_no_result():
    """The measuring path refuses a machine without CUDA: exit 2 and no
    line on standard output, never a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "nnformer_unetr.train.b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "does not fall back" in out.stderr


def test_only_the_benchmark_files_is_not_enough(tmp_path):
    """In a folder with BENCHMARK.json and portbench/ alone the program is
    missing, and the run fails."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = (
        "import sys, time, torch; sys.path = [p for p in sys.path if p != %r]"
        "; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "from portbench.tests.conftest import small_cell\n"
        "harness.run_cell(small_cell('nnformer_unetr.train.b8'), 1, 0.5, "
        "False, torch.device('cpu'), time.perf_counter())\n"
        % (ROOT, str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "medicalsemseg_tpu_torch" in out.stderr


def test_runs_load_no_jax():
    """What the harness loads for a run (every traffic generator, metric
    reader and reference, the program's modules they import), compared by
    top-level name: never JAX, never the JAX package."""
    code = (
        "import sys, glob, os; sys.path.insert(0, %r)\n"
        "from portbench import harness, controls\n"
        "import portbench.reference.nnformer_unetr, "
        "portbench.reference.swin_unetr\n"
        "for p in glob.glob(os.path.join(%r, 'portbench', '*', '*.py')):\n"
        "    if '/tests/' not in p and '/reference/' not in p:\n"
        "        harness.load_module(p)\n"
        "import medicalsemseg_tpu_torch.cli.run_test, "
        "medicalsemseg_tpu_torch.train.loop\n"
        "bad = harness.forbidden_modules()\n"
        "print(bad); sys.exit(1 if bad else 0)\n" % (ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stdout + out.stderr


def test_forbidden_names_are_whole_top_level_names():
    mods = dict(sys.modules)
    try:
        sys.modules["medicalsemseg_tpu_torch_fake"] = object()
        sys.modules["jaxlike"] = object()
        assert "medicalsemseg_tpu_torch_fake" not in harness.forbidden_modules()
        assert "jaxlike" not in harness.forbidden_modules()
        sys.modules["medicalsemseg_tpu.models"] = object()
        assert "medicalsemseg_tpu.models" in harness.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(mods):
            del sys.modules[k]


def test_trace_reduction():
    """Busy time, gaps named by the host, and ops inside model calls from a
    chrome trace."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": profiled.WINDOW,
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": profiled.MODEL,
         "ts": 5, "dur": 30, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 50,
         "dur": 40, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 6, "dur": 1, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 40, "dur": 1, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "window_attention_heads_tc",
         "ts": 10, "dur": 20, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 25,
         "dur": 30, "args": {"correlation": 8}},
    ]
    s = profiled.reduce_trace(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(45e-6)
    assert ("window_attention_heads_tc", 20.0, True) in s["ops"]
    assert ("elementwise", 30.0, False) in s["ops"]
    names = dict((n, sec) for sec, n in s["gaps"])
    assert names["aten::copy_"] == pytest.approx(45e-6)
