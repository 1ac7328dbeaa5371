"""Readings of the comparison's control and of the faults a cell can have,
at the cell's own size, for setting its limits (``portbench/tests``
``test_portbench_controls.py`` runs them; the benchmark's runs do not).

* training: the reference in fp8 (``precision.Fp8``) in the program's
  place, and the reference with half of each batch left out (the mean
  taken over the rest), each against the fp32 reference;
* prediction: the fp8 reference's labels (its argmax) against the fp32
  reference's logits, on the largest volume of the mix.

A state left unchanged reads 1 on ``update`` by the measure and needs no
run; the exchange between chips does not exist on one chip.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench import checks, harness
from portbench.reference import sliding_window as rsw


def _meta_shapes(cfg) -> Dict:
    from medicalsemseg_tpu_torch.models.factory import build_model

    with torch.device("meta"):
        model = build_model(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def train_readings(cell, seed: int, device) -> Dict[str, Dict[str, float]]:
    gen = harness.load_module(harness.traffic_path(cell))
    cfg = gen.port_config(cell, device)
    w, pool, s = gen.inputs(cell, cfg, _meta_shapes(cfg), seed, device)
    theta0 = {k: v.cpu() for k, v in w.items()}
    del w
    batches = pool[:gen.COMPARED]
    ref = gen.reference(cell, batches, theta0, s, device)
    out = {}
    for name, kw in (("fp8", {"prec_name": "fp8"}),
                     ("half_batch", {"crops": range(cell.mix["batch"] // 2)})):
        r = gen.reference(cell, batches, theta0, s, device, **kw)
        out[name] = checks.train_numbers(r["losses"], r["first_grad"],
                                         r["delta"], ref)
    return out


def predict_readings(cell, seed: int, device) -> Dict[str, Dict[str, float]]:
    gen = harness.load_module(harness.traffic_path(cell))
    cfg = gen.port_config(cell, device, "")
    w, samples, s = gen.inputs(cell, cfg, _meta_shapes(cfg), seed, device)
    theta0 = {k: v.cpu() for k, v in w.items()}
    del w
    big = max(samples, key=lambda v: v.image.size)
    exact = gen.reference_logits(cell, cfg, big, theta0, device)
    low = gen.reference_logits(cell, cfg, big, theta0, device, "fp8")
    labels = low.argmax(-1)
    del low
    return {"fp8": {"label_gap": rsw.widest_gap(exact, labels)}}
