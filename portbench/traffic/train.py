"""Training traffic: a closed loop of training steps through the port's own
epoch loop (``train.loop.train_one_epoch`` driving
``train.state.make_train_step``), on a pool of batches of synthetic CT
crops made on the device from the seed, cycled epoch after epoch.

Set-up builds one train state, drives it from the seed through its first
three steps (through ``train_one_epoch``, one single-step epoch each, on the
pool's first three batches), then hands the same state to the window. The
window holds whole steps: none starts after ``--seconds``, and the rate
divides by the time to the last step's end. Once it has closed, the
reference follows the first three steps from the same weights, batches and
DropPath draws, and the comparison decides ``correct``.

The mix's parameters: ``batch`` (crops a step), ``pool`` (batches made at
set-up, the benchmark loader's epoch), ``warmup_steps`` (steps, beyond the
three compared, before the window), ``profile_from`` and ``profile_steps``
(the window's steps that ``--trace 1`` profiles).
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import checks, profiled, record, synth, weights
from portbench.reference import train as rtrain
from portbench.reference.precision import PRECISIONS, no_tf32

COMPARED = 3


def seeds(seed: int) -> Dict[str, int]:
    """Independent 63-bit seeds of the run's draws."""
    ss = np.random.SeedSequence(seed)
    w, d, p = (int(s.generate_state(2, np.uint64)[0] >> np.uint64(1))
               for s in ss.spawn(3))
    return {"weights": w, "data": d, "drop_path": p}


def make_step(cfg):
    """The program's train step (the tests plant faults here)."""
    from medicalsemseg_tpu_torch.train.state import make_train_step

    return make_train_step(cfg)


class PoolLoader:
    """The benchmark's loader: batches of the pool in order, from ``start``,
    until ``stop()`` says so, calling ``before(i)`` ahead of the i-th."""

    def __init__(self, pool: List[Dict], start: int, count=None,
                 stop=None, before=None):
        self.pool, self.start, self.count = pool, start, count
        self.stop, self.before = stop, before

    def steps_per_epoch(self) -> int:
        return self.count if self.count is not None else 10 ** 9

    def epoch(self, epoch: int):
        i = 0
        while (self.count is None or i < self.count) and not (
                self.stop is not None and self.stop()):
            if self.before is not None:
                self.before(i)
            yield self.pool[(self.start + i) % len(self.pool)]
            i += 1


def port_config(cell, device):
    from medicalsemseg_tpu_torch.config import get_args

    return get_args(record.argv(cell.config["flags"], {
        "n_images_per_batch": cell.mix["batch"], "device": str(device)}))


def inputs(cell, cfg, shapes, seed, device):
    """The weights (name -> fp32 leaf, on ``device``) and the pool of
    batches the benchmark makes from ``seed`` for parameters of ``shapes``;
    and the run's seeds."""
    mix = cell.mix
    s = seeds(seed)
    w = weights.make_weights(shapes, s["weights"], device)
    gen = torch.Generator(device=device)
    gen.manual_seed(s["data"])
    pool = []
    for _ in range(mix["pool"]):
        img, lab = synth.ct_volumes(mix["batch"], cfg.vol_size3(),
                                    cfg.output_dim, gen, device)
        pool.append({
            "image": img[..., None], "label": lab,
            "crop_loc": torch.rand(mix["batch"], 3, generator=gen,
                                   device=device),
            "affine": torch.tensor(mix["spacing"], device=device).expand(
                mix["batch"], 3).contiguous()})
    return w, pool, s


def build(cell, seed, device):
    """The program's model and train state, and the weights and pool the
    benchmark made; all from ``seed``."""
    from medicalsemseg_tpu_torch.models.factory import build_model
    from medicalsemseg_tpu_torch.train.state import create_train_state

    cfg = port_config(cell, device)
    with torch.device(device):
        model = build_model(cfg)
    model.to(device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w, pool, s = inputs(cell, cfg, shapes, seed, device)
    model.load_state_dict(w, strict=True)
    state = create_train_state(cfg, model, cell.mix["pool"],
                               seed=s["drop_path"])
    theta0 = {k: v.detach().to("cpu", copy=True) for k, v in w.items()}
    return cfg, state, pool, theta0, s


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float
        ) -> Dict:
    from medicalsemseg_tpu_torch.train.loop import train_one_epoch

    mix = cell.mix
    cfg, state, pool, theta0, s = build(cell, seed, device)
    model = state.model
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)

    spans = profiled.Spans(trace and on_card)
    sub = profiled.SubWindow(
        record.launch_counts if trace and on_card else None,
        "train_one_epoch, outside the step")
    step_fn = make_step(cfg)
    step_no = [0]

    def step(st, batch):
        spans.mark("step")
        t = spans.begin()
        with sub.span("portbench.step"):
            out = step_fn(st, batch)
        spans.end("body", t, step_no[0])
        step_no[0] += 1
        return out

    fwd = {}
    if spans.on:
        model.register_forward_pre_hook(
            lambda m, a: fwd.__setitem__("t", spans.begin()))
        model.register_forward_hook(
            lambda m, a, o: spans.end("fwd", fwd.pop("t", None),
                                      step_no[0]))

    # the three compared steps, then warm-up steps; all through the loop
    losses, first_grad = [], None
    for i in range(COMPARED + mix["warmup_steps"]):
        _, stats = train_one_epoch(state, step, PoolLoader(pool, i, 1), 0,
                                   cfg)
        if i < COMPARED:
            losses.append(stats["train/loss"])
        if i == 0:
            b1 = state.optimizer.param_groups[0]["betas"][0]
            first_grad = {n: float(state.optimizer.state[params[n]][
                "exp_avg"].norm()) / (1 - b1) for n in names}
        if i == COMPARED - 1:
            delta = {n: float((params[n].detach().cpu() - theta0[n]).norm())
                     for n in names}
    ref_batches = [{k: v.clone() for k, v in pool[i].items()}
                   for i in range(COMPARED)]

    # the window
    step_no[0] = 0
    spans.events.clear()
    spans.marks.clear()
    start = COMPARED + mix["warmup_steps"]
    pa, pn = mix["profile_from"], mix["profile_steps"]

    def before(i):
        if trace and on_card:
            if i == pa:
                sub.start()
            elif i == pa + pn:
                sub.stop()

    if on_card:
        torch.cuda.synchronize()
    t_win = time.perf_counter()
    setup_s = t_win - t0
    loader = PoolLoader(pool, start, None,
                        lambda: time.perf_counter() >= t_win + seconds, before)
    train_one_epoch(state, step, loader, 0, cfg)
    if on_card:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    if sub.active:
        sub.stop()
    sub.reduce()
    steps = step_no[0]
    crops = steps * mix["batch"]
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    print(f"portbench: {steps} steps of {mix['batch']} crops in "
          f"{t_end - t_win:.3f} s after {setup_s:.3f} s of set-up",
          file=sys.stderr)

    rec = None
    if trace:
        rec = record.Record(
            kind="train", cell=cell, spans=spans.read() if spans.on else {},
            host={}, profiled=(pa, pa + pn), trace=sub.summary)
        rec.flops_per_item = record.model_flops(
            cell, {k: tuple(v.shape) for k, v in theta0.items()},
            cfg.vol_size3(), train=True)
    del state, model, params, pool, loader, step_fn
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference(cell, ref_batches, theta0, s, device)
    print(f"portbench: the reference's {COMPARED} steps took "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    numbers = checks.train_numbers(losses, first_grad, delta, ref)
    return {"attempted": steps, "failed": 0,
            "end_to_end": {"train_crops_per_s": crops / (t_end - t_win),
                           "peak_gib": peak / 2 ** 30, "setup_s": setup_s},
            "checks": checks.with_limits(numbers, cell.limits),
            "record": rec,
            "device": record.device_fields(device, peak, sub.summary),
            "breakdown": record.breakdown(sub.summary)}


def reference(cell, batches, theta0, s, device, prec_name="fp32",
              crops=()) -> Dict:
    """The reference's first steps from the same weights, batches and
    DropPath draws (drawn again from the same seed, in the same order)."""
    ref_mod = record.reference_module(cell)
    flags = cell.config["flags"]
    prec = PRECISIONS[prec_name]
    gen = torch.Generator(device=device)
    gen.manual_seed(s["drop_path"])
    masks = [ref_mod.draw_masks(flags, cell.mix["batch"], gen, device)
             for _ in batches]
    lrs = [rtrain.lr_at(i, flags, cell.mix["pool"])
           for i in range(len(batches))]
    P = {k: v.to(device) for k, v in theta0.items()}
    with no_tf32():
        out = rtrain.train_steps(
            lambda p, v, m: ref_mod.forward(p, flags, v, m, prec), P, batches,
            masks, lrs, flags, crops)
    return {"losses": out["losses"],
            "first_grad": {k: float(v.norm())
                           for k, v in out["first_grad"].items()},
            "delta": {k: float((v.cpu() - theta0[k]).norm())
                      for k, v in out["params"].items()}}
