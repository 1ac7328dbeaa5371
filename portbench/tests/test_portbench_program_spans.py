"""The readers of the program's spans (``portbench/metrics/``, source
``program_span``) on the CPU: each is fed the spans of a small cell's run
with the program's tracing on (``profiling.enable()``) and reads a number
from them; on an empty buffer each reads None."""

from __future__ import annotations

import os
import time

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import ROOT, SEED, small_cell
from medicalsemseg_tpu_torch.utils import profiling

READERS = {
    "nnformer_unetr.train.b8": [
        "train_step.forward_ms.train", "train_step.backward_ms.train",
        "train_step.recompute_ms.train", "train_step.update_ms.train",
        "train_one_epoch.between_steps_ms.train", "kernels.wrapper_ms.train"],
    "nnformer_unetr.predict.ct4": [
        "sw.predictor_ms.predict", "sw.blend_ms.predict",
        "sw.pad_ms.predict", "test_model.h2d_ms.predict",
        "test_model.readback_ms.predict", "kernels.wrapper_ms.predict"],
}
CASES = [(cell, m) for cell, ms in READERS.items() for m in ms]


def _reader(metric):
    return harness.load_module(os.path.join(ROOT, "portbench", "metrics",
                                            metric + ".py"))


@pytest.fixture(scope="module")
def traced():
    """cell -> (its record, the spans of its run with tracing on)."""
    out = {}
    for name in READERS:
        cell = small_cell(name)
        gen = harness.load_module(harness.traffic_path(cell))
        profiling.reset()
        profiling.enable()
        try:
            run = gen.run(cell, seed=SEED, seconds=1.0, trace=True,
                          device=torch.device("cpu"),
                          t0=time.perf_counter())
        finally:
            profiling.disable()
        out[name] = (run["record"], profiling.spans())
        profiling.reset()
    return out


def test_every_reader_is_an_entry():
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for cell, metric in CASES:
        m = entries[metric]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert cell in m["workloads"]


@pytest.mark.parametrize("cell,metric", CASES)
def test_reader_reads_the_programs_spans(traced, monkeypatch, cell, metric):
    rec, spans = traced[cell]
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    v = _reader(metric).read(rec)
    assert isinstance(v, float) and v > 0, (metric, v)


@pytest.mark.parametrize("cell,metric", CASES)
def test_reader_reads_none_from_an_empty_buffer(traced, cell, metric):
    profiling.reset()
    assert _reader(metric).read(traced[cell][0]) is None


def test_readers_read_none_from_a_program_without_spans(traced,
                                                        monkeypatch):
    """Laid over a checkout whose program has no spans, a reader reads
    None and does not raise."""
    monkeypatch.delattr(profiling, "spans")
    for cell, metric in CASES:
        assert _reader(metric).read(traced[cell][0]) is None


def test_recompute_reads_none_without_remat(monkeypatch):
    """The recompute reader where no block is recomputed (``--remat
    none``): None, as in a model that ignores ``--remat``."""
    cell = small_cell("nnformer_unetr.train.b8", remat="none")
    gen = harness.load_module(harness.traffic_path(cell))
    profiling.reset()
    profiling.enable()
    try:
        run = gen.run(cell, seed=SEED, seconds=0.5, trace=True,
                      device=torch.device("cpu"), t0=time.perf_counter())
    finally:
        profiling.disable()
    try:
        assert _reader("train_step.backward_ms.train").read(run["record"]) > 0
        assert _reader("train_step.recompute_ms.train").read(
            run["record"]) is None
    finally:
        profiling.reset()
