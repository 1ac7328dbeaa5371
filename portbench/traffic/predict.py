"""Prediction traffic: a closed loop of CT volumes, one at a time, through
the port's prediction entry ``cli/run_test.py:test_model`` (bucket padding,
Gaussian ``sliding_window_inference``, the argmax, the label map on the
host), one volume a call.

The volumes are synthetic CT (``portbench/synth.py``) made on the device
from the seed and handed over as host float32 arrays, as a loader does;
one of each of the mix's shapes (``mix_shapes``). They come in cycles that
hold each shape once, in an order drawn from the seed for every cycle, and
the window holds whole cycles: none starts after ``--seconds``. So every
seed does the same work in another order, and the 90th percentile of
latency falls inside the largest shape's class. A volume's latency runs
from handing its array to ``test_model`` to the label map on the host.

``test_model`` writes its label maps only with ``save_eval_output``; the
run sets it and puts a capture in place of the module's NIfTI writer, so
nothing is encoded or written and the label map the program put out is
kept for the comparison: once the window has closed, a sample of volumes
drawn from the seed (one of the largest shape, and one other) is predicted
by the reference, and the widest gap by which a label's reference logit
lies below the reference's best decides ``correct``.

The mix's parameters: ``source`` (where its sizes are published),
``fov_mm`` (two fields of view, mm per axis: the published smallest and
largest), ``fov_points`` (one volume a point, each a fraction of the way
from the first field of view to the second), ``spacing`` (mm per voxel:
a volume's shape is its field of view over it, rounded),
``bucket_multiple`` (the port pads a volume's axes to multiples of it; the
reference does too), ``windows_per_call`` (``--batch_size_val``),
``profile_from`` and ``profile_volumes`` (the window's volumes that
``--trace 1`` profiles), ``sample`` (volumes compared). The warm-up runs
every predictor call size that the shapes make (``call_sizes``).
"""

from __future__ import annotations

import os
import statistics
import sys
import tempfile
import time
import types
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import checks, profiled, record, synth, weights
from portbench.reference import sliding_window as rsw
from portbench.reference.precision import PRECISIONS, no_tf32


def seeds(seed: int) -> Dict[str, int]:
    ss = np.random.SeedSequence(seed)
    w, d, o = (int(s.generate_state(2, np.uint64)[0] >> np.uint64(1))
               for s in ss.spawn(3))
    return {"weights": w, "data": d, "order": o}


class Capture:
    """Stands in for ``run_test``'s NIfTI module: keeps the label map that
    ``test_model`` would write under ``pred/`` and writes nothing."""

    def __init__(self):
        self.pred = None

    @staticmethod
    def NiftiImage(array, affine):  # noqa: N802 (the module's name)
        return array

    def save(self, image, path):
        if os.path.basename(os.path.dirname(path)) == "pred":
            self.pred = image


def mix_shapes(mix) -> List[Tuple[int, int, int]]:
    """The mix's volumes in voxels: at each of ``fov_points``, the field of
    view that lies that fraction of the way between the two of ``fov_mm``,
    resampled to ``spacing`` and rounded to the nearest voxel."""
    lo, hi = (np.asarray(v, np.float64) for v in mix["fov_mm"])
    spacing = np.asarray(mix["spacing"], np.float64)
    return [tuple(int(v) for v in np.floor((lo + f * (hi - lo)) / spacing
                                           + 0.5))
            for f in mix["fov_points"]]


def call_sizes(mix, roi, overlap: float) -> List[int]:
    """The sizes of the predictor calls that the mix's volumes make, each
    once, largest first: a volume padded to multiples of
    ``bucket_multiple`` (and at least to the ROI) has as many windows as
    ``rsw.window_starts`` gives, predicted ``windows_per_call`` a call,
    the last call holding the rest."""
    k, m = mix["windows_per_call"], mix["bucket_multiple"]
    sizes = set()
    for shape in mix_shapes(mix):
        padded = [max(-(-s // m) * m, r) for s, r in zip(shape, roi)]
        n = len(rsw.window_starts(padded, roi, overlap))
        sizes.add(min(n, k))
        if n > k and n % k:
            sizes.add(n % k)
    return sorted(sizes, reverse=True)


def deliver(pred: np.ndarray) -> np.ndarray:
    """The label map as the program put it out (the tests alter it here)."""
    return pred


def port_config(cell, device, out_dir):
    from medicalsemseg_tpu_torch.config import get_args

    return get_args(record.argv(cell.config["flags"], {
        "batch_size_val": cell.mix["windows_per_call"],
        "save_eval_output": True, "output_dir": out_dir,
        "device": str(device)}))


def inputs(cell, cfg, shapes, seed, device):
    """The weights (name -> fp32 leaf, on ``device``) and one volume of each
    of the mix's shapes (host samples) from ``seed``; and the run's seeds."""
    mix = cell.mix
    s = seeds(seed)
    w = weights.make_weights(shapes, s["weights"], device)
    gen = torch.Generator(device=device)
    gen.manual_seed(s["data"])
    affine = np.diag(list(mix["spacing"]) + [1.0])
    samples = []
    for i, shape in enumerate(mix_shapes(mix)):
        img, _ = synth.ct_volumes(1, shape, cfg.output_dim, gen, device)
        samples.append(types.SimpleNamespace(
            image=img[0, ..., None].cpu().numpy(), label=None,
            affine=affine, original_affine=affine,
            original_shape=tuple(shape), name=f"ct{i}.nii.gz"))
    return w, samples, s


def build(cell, seed, device, out_dir):
    from medicalsemseg_tpu_torch.models.factory import build_model

    cfg = port_config(cell, device, out_dir)
    with torch.device(device):
        model = build_model(cfg)
    model.to(device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w, samples, s = inputs(cell, cfg, shapes, seed, device)
    model.load_state_dict(w, strict=True)
    model.eval()
    theta0 = {k: v.detach().to("cpu", copy=True) for k, v in w.items()}
    return cfg, model, samples, theta0, s


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float
        ) -> Dict:
    from medicalsemseg_tpu_torch.cli import run_test

    on_card = device.type == "cuda"
    tmp = tempfile.TemporaryDirectory()
    writer = run_test.nifti
    capture = Capture()
    run_test.nifti = capture
    try:
        out = _run(cell, seed, seconds, trace, device, t0, run_test, capture,
                   tmp.name, on_card)
    finally:
        run_test.nifti = writer
        tmp.cleanup()
    return out


def _run(cell, seed, seconds, trace, device, t0, run_test, capture, out_dir,
         on_card):
    mix = cell.mix
    cfg, model, samples, theta0, s = build(cell, seed, device, out_dir)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    spans = profiled.Spans(trace and on_card)
    sub = profiled.SubWindow(
        record.launch_counts if trace and on_card else None,
        "between volumes")
    vol_no = [0]
    call = {}
    if spans.on:
        def pre(m, args):
            call["rf"] = sub.model_call()
            call["rf"].__enter__()
            call["t"] = spans.begin()

        def post(m, args, out):
            spans.end("call", call.pop("t", None),
                      (vol_no[0], int(args[0][0].shape[0])))
            call.pop("rf").__exit__(None, None, None)

        model.register_forward_pre_hook(pre)
        model.register_forward_hook(post)

    roi = cfg.vol_size3()
    with torch.inference_mode():
        # warm-up: the predictor calls of every size the shapes make, and
        # the smallest volume through the whole path
        for k in call_sizes(mix, roi, cfg.val_infer_overlap):
            wins = torch.zeros((k,) + roi + (1,), device=device)
            model((wins, torch.zeros(k, 3, device=device),
                   torch.ones(k, 3, device=device)))
        small = min(range(len(samples)),
                    key=lambda i: np.prod(samples[i].image.shape))
        run_test.test_model(model, [samples[small]], cfg, device)
    spans.events.clear()

    order = np.random.default_rng(s["order"])
    done = []   # (shape index, seconds, label map)
    pa, pn = mix["profile_from"], mix["profile_volumes"]
    if on_card:
        torch.cuda.synchronize()
    t_win = time.perf_counter()
    setup_s = t_win - t0
    with torch.inference_mode():
        while time.perf_counter() < t_win + seconds:
            for j in order.permutation(len(samples)):
                if trace and on_card and len(done) == pa:
                    sub.start()
                if trace and on_card and len(done) == pa + pn:
                    sub.stop()
                vol_no[0] = len(done)
                t = time.perf_counter()
                with sub.span("portbench.volume"):
                    run_test.test_model(model, [samples[j]], cfg, device)
                done.append((int(j), time.perf_counter() - t,
                             deliver(capture.pred)))
    if on_card:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    if sub.active:
        sub.stop()
    sub.reduce()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    lat = [d[1] for d in done]
    shapes = mix_shapes(mix)
    voxels = sum(int(np.prod(shapes[j])) for j, _, _ in done)
    p90 = statistics.quantiles(lat, n=10, method="inclusive")[-1]
    print(f"portbench: {len(done)} volumes ({len(done) // len(samples)} "
          f"cycles of {len(samples)}) in {t_end - t_win:.3f} s after "
          f"{setup_s:.3f} s of set-up; the 90th percentile of {len(lat)} "
          f"latencies is {p90:.4f} s", file=sys.stderr)

    rec = None
    if trace:
        rec = record.Record(
            kind="predict", cell=cell,
            spans=spans.read() if spans.on else {},
            host={"volume": lat}, profiled=(pa, pa + pn), trace=sub.summary)
        rec.flops_per_item = record.model_flops(
            cell, {k: tuple(v.shape) for k, v in theta0.items()}, roi,
            train=False)
    del model
    if on_card:
        torch.cuda.empty_cache()

    picked = pick(done, mix, s)
    t_ref = time.perf_counter()
    gap = max(checks_gap(cell, cfg, samples[done[i][0]], done[i][2], theta0,
                         device) for i in picked)
    print(f"portbench: the reference's {len(picked)} volumes took "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    return {"attempted": len(done), "failed": 0,
            "end_to_end": {"predict_mvox_per_s": voxels / 1e6
                           / (t_end - t_win),
                           "predict_p90_s": p90,
                           "peak_gib": peak / 2 ** 30, "setup_s": setup_s},
            "checks": checks.with_limits({"label_gap": gap}, cell.limits),
            "record": rec,
            "device": record.device_fields(device, peak, sub.summary),
            "breakdown": record.breakdown(sub.summary)}


def pick(done, mix, s) -> list:
    """The compared volumes, drawn from the seed: one of the largest shape
    and ``sample - 1`` others."""
    rng = np.random.default_rng(s["order"] + 1)
    shapes = mix_shapes(mix)
    sizes = [int(np.prod(shapes[j])) for j, _, _ in done]
    largest = [i for i, v in enumerate(sizes) if v == max(sizes)]
    first = int(rng.choice(largest))
    rest = [i for i in range(len(done)) if i != first]
    more = rng.choice(rest, size=min(mix["sample"] - 1, len(rest)),
                      replace=False).tolist() if rest else []
    return [first] + [int(i) for i in more]


def reference_logits(cell, cfg, sample, theta0, device, prec_name="fp32"):
    ref_mod = record.reference_module(cell)
    flags = cell.config["flags"]
    prec = PRECISIONS[prec_name]
    P = {k: v.to(device) for k, v in theta0.items()}
    with no_tf32():
        return rsw.predict(
            lambda w: ref_mod.forward(P, flags, w, None, prec), sample.image,
            cfg.vol_size3(), cfg.output_dim, cfg.val_infer_overlap,
            cell.mix["bucket_multiple"], device)


def checks_gap(cell, cfg, sample, pred, theta0, device) -> float:
    logits = reference_logits(cell, cfg, sample, theta0, device)
    return rsw.widest_gap(logits, torch.from_numpy(np.asarray(pred)))
