"""A run with the timed path broken underneath comes out not correct: the
harness is driven on the CPU (its look for a card skipped) at a small size,
once for each fault a cell can have. A sound run at that size comes out
correct, so each refusal is the fault's."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.conftest import SEED, small_cell


def _run(cell):
    return harness.run_cell(cell, SEED, 0.5, False, torch.device("cpu"),
                            time.perf_counter())


def _gen(cell):
    return harness.load_module(harness.traffic_path(cell))


def _unchanged(make):
    """A train step that returns its state unchanged: the parameters are
    put back after each step."""
    def make_step(cfg):
        real = make(cfg)

        def step(state, batch):
            keep = [p.detach().clone() for p in state.model.parameters()]
            out = real(state, batch)
            with torch.no_grad():
                for p, k in zip(state.model.parameters(), keep):
                    p.copy_(k)
            return out
        return step
    return make_step


def _half_batch(make):
    """A train step that leaves half of the batch out, the mean taken over
    the rest."""
    def make_step(cfg):
        real = make(cfg)

        def step(state, batch):
            half = batch["image"].shape[0] // 2
            return real(state, {k: v[:half] for k, v in batch.items()})
        return step
    return make_step


@pytest.mark.parametrize("name", ["nnformer_unetr.train.b8",
                                  "swin_unetr.train.b8"])
@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch])
def test_train_faults(monkeypatch, name, fault):
    cell = small_cell(name)
    gen = _gen(cell)
    if fault is not None:
        monkeypatch.setattr(gen, "make_step", fault(gen.make_step))
    out = _run(cell)
    assert out["correct"] is (fault is None), out["checks"]


def _altered(pred):
    """An answer altered where it is produced: a slab of the label map
    moved to the next class."""
    pred = np.array(pred, copy=True)
    pred[: max(pred.shape[0] // 8, 1)] = (pred[: max(pred.shape[0] // 8, 1)]
                                         + 1) % 5
    return pred


@pytest.mark.parametrize("name", ["nnformer_unetr.predict.ct4",
                                  "swin_unetr.predict.ct4"])
@pytest.mark.parametrize("fault", [None, _altered])
def test_predict_faults(monkeypatch, name, fault):
    cell = small_cell(name)
    if fault is not None:
        monkeypatch.setattr(_gen(cell), "deliver", fault)
    out = _run(cell)
    assert out["correct"] is (fault is None), out["checks"]
