"""Shared pieces of the benchmark's tests: the cells cut to a size the CPU
holds (crops of 32^3, hidden 12, 5 classes, fp32 unless a test asks for
bf16), and one card check made inside a fixture."""

from __future__ import annotations

import dataclasses
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

SMALL_FLAGS = {"vol_size": 32, "hidden_dim": 12, "output_dim": 5,
               "compute_dtype": "float32"}
SMALL_MIX = {
    "train": {"batch": 2, "pool": 4, "warmup_steps": 0, "profile_from": 2,
              "profile_steps": 2},
    "predict": {"fov_mm": [[60, 54, 68], [72, 60, 60]], "fov_points": [0, 1],
                "windows_per_call": 4, "profile_from": 2,
                "profile_volumes": 2, "sample": 2},
}
SEED = 2 ** 31 + 4099


def small_cell(name: str, **flags) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json at the CPU's size."""
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cell = harness.find_cell(bench, name)
    config = dict(cell.config)
    config["flags"] = {**config["flags"], **SMALL_FLAGS, **flags}
    mix = {**cell.mix, **SMALL_MIX[cell.mix["kind"]]}
    return dataclasses.replace(cell, config=config, mix=mix)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
