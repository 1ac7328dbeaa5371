"""The comparison's control: the reference computed in fp8 in the program's
place has to come out not correct, and so has the reference with half of
each batch left out. At each cell's own size on the card (marked ``cuda``),
three seeds a cell, against the cell's limits, with the readings kept (they
are the upper readings the limits were set from); on the CPU at a small
size, against the program's own reading there."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from portbench import controls, harness
from portbench.tests.conftest import ROOT, SEED, small_cell

TRAIN = ["nnformer_unetr.train.b8", "swin_unetr.train.b8"]
PREDICT = ["nnformer_unetr.predict.ct4", "swin_unetr.predict.ct4"]
CARD_SEEDS = [3 * 2 ** 31 + 11, 3 * 2 ** 31 + 12, 3 * 2 ** 31 + 13]


def _fails(cell, numbers):
    """Whether one of the cell's compared numbers is over its limit."""
    return any(numbers[k] > lim["limit"] for k, lim in cell.limits.items())


def _sound(cell):
    """The program's own readings at the small size, through the harness."""
    out = harness.run_cell(cell, SEED, 0.5, False, torch.device("cpu"),
                           time.perf_counter())
    return {k: c["value"] for k, c in out["checks"].items()}


def _separates(cell, sound, numbers):
    """Whether a compared number reads three times the sound run's."""
    return any(numbers[k] >= 3 * sound[k] for k in cell.limits)


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_separates_small(name):
    """At the CPU's size the limits of the cell's own size do not apply;
    the control and the fault read three times the sound bf16 run or more
    on one of the compared numbers."""
    cell = small_cell(name, compute_dtype="bfloat16")
    sound = _sound(cell)
    out = controls.train_readings(cell, SEED, torch.device("cpu"))
    for reading in out.values():
        assert _separates(cell, sound, reading), (sound, out)


@pytest.mark.parametrize("name", PREDICT)
def test_predict_control_separates_small(name):
    cell = small_cell(name, compute_dtype="bfloat16")
    sound = _sound(cell)
    out = controls.predict_readings(cell, SEED, torch.device("cpu"))
    assert _separates(cell, sound, out["fp8"]), (sound, out)


def _full(name):
    return harness.find_cell(harness.load_json(ROOT, "BENCHMARK.json"), name)


def _keep(name, seed, out):
    path = os.path.join(ROOT, "chiprun_out", "controls.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps({"cell": name, "seed": seed, **out}) + "\n")
    print(name, seed, out)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CARD_SEEDS)
@pytest.mark.parametrize("name", TRAIN)
def test_train_control_fails_on_card(cuda_device, name, seed):
    cell = _full(name)
    out = controls.train_readings(cell, seed, cuda_device)
    _keep(name, seed, out)
    for reading in out.values():
        assert _fails(cell, reading), out


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CARD_SEEDS)
@pytest.mark.parametrize("name", PREDICT)
def test_predict_control_fails_on_card(cuda_device, name, seed):
    cell = _full(name)
    out = controls.predict_readings(cell, seed, cuda_device)
    _keep(name, seed, out)
    assert _fails(cell, out["fp8"]), out
