"""The program's own readings of the compared numbers over a dozen seeds
or more, through the harness's path on the card (marked ``cuda``): the
lower readings the limits were set from. Each seed's numbers go to
``chiprun_out/readings.jsonl``; every run has to come out correct."""

from __future__ import annotations

import json
import os
import time

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT

CELLS = ["nnformer_unetr.train.b8", "nnformer_unetr.predict.ct4",
         "swin_unetr.train.b8", "swin_unetr.predict.ct4"]
SEEDS = [5 * 2 ** 31 + k for k in range(12)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_sound_readings_on_card(cuda_device, name):
    cell = harness.find_cell(harness.load_json(ROOT, "BENCHMARK.json"), name)
    path = os.path.join(ROOT, "chiprun_out", "readings.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    wrong = []
    for seed in SEEDS:
        out = harness.run_cell(cell, seed, 1.0, False, cuda_device,
                               time.perf_counter())
        numbers = {k: c["value"] for k, c in out["checks"].items()}
        with open(path, "a") as f:
            f.write(json.dumps({"cell": name, "seed": seed,
                                "correct": out["correct"], **numbers}) + "\n")
        if not out["correct"]:
            wrong.append((seed, numbers))
    assert not wrong, wrong
