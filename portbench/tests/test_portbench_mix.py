"""The prediction mix's sizes, worked out from its published source, and
the warm-up's call sizes, worked out from the mix, held against the calls
that the port's ``test_model`` makes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.conftest import ROOT, SEED, small_cell

PREDICT = harness.load_module(harness.traffic_path(harness.find_cell(
    harness.load_json(ROOT, "BENCHMARK.json"), "nnformer_unetr.predict.ct4")))


def test_ct4_shapes_from_the_published_fields_of_view():
    """280 + f * 220 mm in-plane over 1.5 mm, 280 + f * 370 mm along the
    body over 2.0 mm, at the middles of the four quarters."""
    mix = harness.load_json(ROOT, "portbench", "traffic", "predict.ct4.json")
    assert PREDICT.mix_shapes(mix) == [(205, 205, 163), (242, 242, 209),
                                       (278, 278, 256), (315, 315, 302)]
    assert PREDICT.call_sizes(mix, (96, 96, 96), 0.5) == [16, 13, 8, 4]


@pytest.mark.parametrize("name", ["nnformer_unetr.predict.ct4",
                                  "swin_unetr.predict.ct4"])
def test_warm_up_covers_every_call(name):
    """Every call size that ``test_model`` makes over the mix's volumes is
    one that the warm-up runs."""
    from medicalsemseg_tpu_torch.cli import run_test

    cell = small_cell(name)
    device = torch.device("cpu")
    cfg, model, samples, _, _ = PREDICT.build(cell, SEED, device, "")
    seen = set()
    model.register_forward_pre_hook(
        lambda m, args: seen.add(int(args[0][0].shape[0])))
    cfg.save_eval_output = False
    with torch.inference_mode():
        run_test.test_model(model, samples, cfg, device)
    assert sorted(seen, reverse=True) == PREDICT.call_sizes(
        cell.mix, cfg.vol_size3(), cfg.val_infer_overlap)
    assert len(samples) == len(cell.mix["fov_points"])
    assert [s.image.shape[:3] for s in samples] == [
        tuple(v) for v in PREDICT.mix_shapes(cell.mix)]
    assert np.all(np.isfinite(samples[0].image))
