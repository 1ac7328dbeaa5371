#!/usr/bin/env python3
"""Smoke run of the PyTorch port (medicalsemseg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. card      - print the card's name and power limit (nvidia-smi);
  2. build     - build the CUDA kernels from csrc/ and print the build time;
  3. kernels   - each kernel (K1 attention, K2 MLP, K3 attention backward, K4
                 MLP backward) against its plain PyTorch version in bf16 at
                 the four flagship stage shapes (batch 2; batch 16 = one
                 predictor call; batch 8 = one training step), every output
                 with its error, and CUDA-event times beside the bound that
                 the FLOP and byte counts give;
  4. model     - the full-width flagship on one 96^3 window in bf16 with the
                 kernels, against the same weights in fp32 on the CPU (plain);
  5. cli       - the label-free prediction CLI on two synthetic CT volumes,
                 with the kernels' launch counts checked against the
                 predictor calls;
  6. train     - the full-width flagship, batch 8 of 96^3, bf16: a few steps
                 through make_train_step (loss finite and falling, launch
                 counts, ms per step, peak memory), and one step's gradients
                 against the fp32 plain path on the same weights, and each
                 Swin block on its own with the kernels against plain;
  7. train_cli - the training CLI on a synthetic Decathlon folder: 2 epochs,
                 validation, checkpoints, then a --resume run.
`--phases profile` (not run by default) prints a torch.profiler table of one
training step. Then one JSON line with the kernels' numbers, and last the line
{"ok": true, "device": {...}}. Imports torch and the port, never jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("card", "build", "kernels", "model", "cli", "train", "train_cli")
EXTRA_PHASES = ("profile",)

# flagship stages at roi 96, patch 2: (token grid, C, heads); window 6
STAGES = ((48, 48, 3), (24, 96, 6), (12, 192, 12), (6, 384, 24))
WS = 6

# bf16 tolerance, kernel vs plain PyTorch on the same bf16 inputs: both round
# to bf16 at the same points and accumulate in fp32, so they differ only
# where a differently ordered fp32 sum flips one intermediate bf16 rounding;
# such a flip moves an O(1) output by a few bf16 ulps (2^-8 relative each).
KERNEL_ATOL = KERNEL_RTOL = 3e-2


class PhaseError(RuntimeError):
    pass


def _require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def _time_ms(fn, iters):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build():
    from medicalsemseg_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.load()
    print(f"build: {kernels.library_path()} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _attn_case(gen, batch, grid, c, nh, shift, ln, res):
    import torch

    from medicalsemseg_tpu_torch.ops import window as tw

    dev, bf = "cuda", torch.bfloat16
    n = WS ** 3
    nw = grid // WS
    x = torch.randn(batch, grid, grid, grid, c, generator=gen,
                    device=dev).to(bf)
    wins = tw.window_partition(x, WS).contiguous()
    s = c ** -0.5
    args = dict(
        wqkv=(torch.randn(3 * c, c, generator=gen, device=dev) * s).to(bf),
        bqkv=torch.randn(3 * c, generator=gen, device=dev) * 0.1,
        wproj=(torch.randn(c, c, generator=gen, device=dev) * s).to(bf),
        bproj=torch.randn(c, generator=gen, device=dev) * 0.1,
        bias=torch.randn(nh, n, n, generator=gen, device=dev))
    kw = dict(grid_dims=(nw,) * 3, window=(WS,) * 3, shift=(shift,) * 3,
              residual=res,
              ln=(torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                               0.1 * torch.randn(c, generator=gen, device=dev)])
                  if ln else None))
    return wins, args, kw


def _mlp_case(gen, batch, grid, c, ln, res):
    import torch

    dev, bf = "cuda", torch.bfloat16
    m = batch * grid ** 3
    x = torch.randn(m, c, generator=gen, device=dev).to(bf)
    args = dict(
        w1=(torch.randn(4 * c, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        b1=torch.randn(4 * c, generator=gen, device=dev) * 0.1,
        w2=(torch.randn(c, 4 * c, generator=gen, device=dev) * (4 * c) ** -0.5).to(bf),
        b2=torch.randn(c, generator=gen, device=dev) * 0.1)
    kw = dict(residual=res,
              ln=(torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                               0.1 * torch.randn(c, generator=gen, device=dev)])
                  if ln else None))
    return x, args, kw


def _compare(name, got, want, report):
    import torch

    _require(got.shape == want.shape and got.dtype == want.dtype,
             f"{name}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    _require(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    err = (g - w).abs()
    max_err = float(err.max())
    ok = bool((err <= KERNEL_ATOL + KERNEL_RTOL * w.abs()).all())
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), max_err)
    print(f"  {name}: max_abs_err {max_err:.3e} "
          f"(tol {KERNEL_ATOL} + {KERNEL_RTOL}*|ref|) {'ok' if ok else 'FAIL'}",
          flush=True)
    _require(ok, f"{name}: kernel disagrees with its plain version")


# Backward outputs, kernel vs plain on the same bf16 inputs. Both round to
# bf16 at the same points; a differently ordered fp32 sum flips single
# intermediate roundings (2^-8 relative each), and a weight gradient adds up
# to 884,736 such terms of either sign, so single elements near zero carry an
# error that is small only against the tensor's scale. Hence: the error's
# norm within 1 % of the reference's, and no element off by more than 5 % of
# the largest reference magnitude.
GRAD_NORM_TOL = 1e-2
GRAD_MAX_TOL = 5e-2


def _compare_grads(name, names, got, want, report):
    import torch

    for nm, g, w in zip(names, got, want):
        if w is None:
            _require(g is None, f"{name} {nm}: expected no gradient")
            continue
        _require(g.shape == w.shape and g.dtype == w.dtype,
                 f"{name} {nm}: {tuple(g.shape)} {g.dtype} vs "
                 f"{tuple(w.shape)} {w.dtype}")
        gf, wf = g.float(), w.float()
        _require(bool(torch.isfinite(gf).all()), f"{name} {nm}: non-finite")
        max_err = float((gf - wf).abs().max())
        scale = float(wf.abs().max())
        rel = float((gf - wf).norm() / wf.norm())
        ok = rel <= GRAD_NORM_TOL and max_err <= GRAD_MAX_TOL * scale
        if nm == "dx":
            report["max_abs_err"] = max(report.get("max_abs_err", 0.0), max_err)
        report["max_rel_err"] = max(report.get("max_rel_err", 0.0), rel)
        print(f"  {name} {nm}: rel norm err {rel:.3e} (tol {GRAD_NORM_TOL}), "
              f"max_abs_err {max_err:.3e} of max|ref| {scale:.3e} "
              f"(tol {GRAD_MAX_TOL}) {'ok' if ok else 'FAIL'}", flush=True)
        _require(ok, f"{name} {nm}: kernel disagrees with its plain version")


# Published peaks of one H100 SXM at its full power limit of 700 W (NVIDIA's
# data sheet): dense bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _work(kind, t, n, c, nh):
    """(FLOPs, bytes) of one call on T windows of N tokens (M = T * N rows):
    every product of the function once, every input read once, every output
    written once (bf16 activations and weights, fp32 biases, bias table and
    weight gradients)."""
    m = t * n
    act = m * c * 2
    if kind == "window_attention":      # qkv, proj; q k^T and p v per head
        return (8 * m * c * c + 4 * t * n * n * c,
                2 * act + 4 * c * c * 2 + 4 * c * 4 + 2 * c * 4
                + nh * n * n * 4)
    if kind == "window_attention_bwd":  # qkv, dout, dWproj, dx, dWqkv;
        # s, o, dp, dv, dq, dk per head
        return (22 * m * c * c + 12 * t * n * n * c,
                3 * act + 4 * c * c * (2 + 4) + 4 * c * (4 + 4) + 2 * c * 8
                + nh * n * n * 8)
    if kind == "fused_mlp":             # fc1, fc2 with hidden 4C
        return (16 * m * c * c, 2 * act + 8 * c * c * 2 + 5 * c * 4 + 2 * c * 4)
    if kind == "fused_mlp_bwd":         # h, dW2, da, dW1, dxn
        return (40 * m * c * c,
                3 * act + 8 * c * c * (2 + 4) + 5 * c * 8 + 2 * c * 8)
    raise ValueError(kind)


def _bound_ms(kind, t, n, c, nh):
    flops, nbytes = _work(kind, t, n, c, nh)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return flops, nbytes, max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                                else "bytes")


PREDICT_BATCH = 16   # windows per predictor call of the prediction path
TRAIN_BATCH = 8      # crops per training step


def _timed(report, kind, label, batch, grid, c, nh, fn, plain_fn, iters):
    """Time kernel and plain version (CUDA events) and put the stage's
    numbers, with the FLOP and byte counts behind its bound, into report."""
    t = batch * (grid // WS) ** 3
    ms = _time_ms(fn, iters)
    pms = _time_ms(plain_fn, iters)
    flops, nbytes, bound, by = _bound_ms(kind, t, WS ** 3, c, nh)
    report["per_stage"].append({
        "C": c, "batch": batch, "path": label, "ms": ms, "plain_ms": pms,
        "flops": flops, "bytes": nbytes, "bound_ms": bound, "bound_by": by})
    print(f"  {report['tag']} {label} grid {grid}^3 x{batch}, C={c}: kernel "
          f"{ms:.3f} ms, plain {pms:.3f} ms, bound {bound:.4f} ms by {by} "
          f"({flops:.3e} FLOP, {nbytes:.3e} B)", flush=True)


def _kernel_reports():
    src = "medicalsemseg_tpu_torch/csrc/"
    ref = "medicalsemseg_tpu/ops/pallas/"
    rows = (("K1", "window_attention", "window_attention.cu",
             "window_attention.py:154"),
            ("K2", "fused_mlp", "mlp.cu", "mlp.py:84"),
            # one kernel for both TPU functions: whole-head :457, head-split :1082
            ("K3", "window_attention_bwd", "window_attention_bwd.cu",
             "window_attention.py:457"),
            ("K4", "fused_mlp_bwd", "mlp_bwd.cu", "mlp.py:276"))
    return {name: {"tag": tag, "name": name, "route": "cuda",
                   "source": src + cu, "replaces": ref + at,
                   "library_ms": None, "per_stage": []}
            for tag, name, cu, at in rows}


K3_NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias", "dln")
K4_NAMES = ("dx", "dln", "dw1", "db1", "dw2", "db2")


def phase_kernels():
    """K1-K4 against their plain versions at every flagship stage, at the
    shapes of the two main paths: one predictor call (16 windows of 96^3)
    and one training step (batch 8)."""
    import torch

    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rep = _kernel_reports()
    k1, k2 = rep["window_attention"], rep["fused_mlp"]
    k3, k4 = rep["window_attention_bwd"], rep["fused_mlp_bwd"]
    with torch.inference_mode():
        for grid, c, nh in STAGES:
            # ---- attention, shifted and unshifted. batch 2: the other
            # forms; batch 16: one predictor call (LN and shortcut in the
            # kernel); batch 8: one training step (LN in the kernel, shortcut
            # outside because DropPath is live, and inside as without it)
            for batch, shift, ln, res in ((2, 0, False, False),
                                          (2, WS // 2, True, True),
                                          (PREDICT_BATCH, WS // 2, True, True),
                                          (PREDICT_BATCH, 0, True, True)):
                wins, a, kw = _attn_case(gen, batch, grid, c, nh, shift, ln,
                                         res)
                got = kwa.window_attention(wins, **a, **kw)
                want = kwa.window_attention_plain(wins, **a, **kw)
                torch.cuda.synchronize()
                _compare(f"K1 grid {grid}^3 x{batch}, C={c}, nh={nh}, shift "
                         f"{shift}, ln {ln}, res {res}", got, want, k1)
                del got, want
            _timed(k1, "window_attention", "predict", PREDICT_BATCH, grid, c,
                   nh, lambda: kwa.window_attention(wins, **a, **kw),
                   lambda: kwa.window_attention_plain(wins, **a, **kw), 10)
            del wins, a, kw
            # forward and backward on the same windows; the training step's
            # own forms come last and are the ones timed
            for batch, shift, ln, res in ((2, WS // 2, False, False),
                                          (TRAIN_BATCH, WS // 2, True, True),
                                          (TRAIN_BATCH, 0, True, True),
                                          (TRAIN_BATCH, WS // 2, True, False),
                                          (TRAIN_BATCH, 0, True, False)):
                wins, a, kw = _attn_case(gen, batch, grid, c, nh, shift, ln,
                                         res)
                case = (f"grid {grid}^3 x{batch}, C={c}, nh={nh}, shift "
                        f"{shift}, ln {ln}, res {res}")
                if batch == TRAIN_BATCH and not res:
                    got = kwa.window_attention(wins, **a, **kw)
                    want = kwa.window_attention_plain(wins, **a, **kw)
                    torch.cuda.synchronize()
                    _compare("K1 " + case, got, want, k1)
                dy = torch.randn(wins.shape, generator=gen,
                                 device="cuda").to(wins.dtype)
                b = {k: v for k, v in a.items() if k != "bproj"}
                got = kwa.window_attention_bwd(wins, dy=dy, **b, **kw)
                want = kwa.window_attention_bwd_plain(wins, dy=dy, **b, **kw)
                torch.cuda.synchronize()
                _compare_grads("K3 " + case, K3_NAMES, got, want, k3)
                del got, want
            _timed(k1, "window_attention", "train", TRAIN_BATCH, grid, c, nh,
                   lambda: kwa.window_attention(wins, **a, **kw),
                   lambda: kwa.window_attention_plain(wins, **a, **kw), 10)
            _timed(k3, "window_attention_bwd", "train", TRAIN_BATCH, grid, c,
                   nh, lambda: kwa.window_attention_bwd(wins, dy=dy, **b, **kw),
                   lambda: kwa.window_attention_bwd_plain(wins, dy=dy, **b,
                                                          **kw), 5)
            del wins, a, b, kw, dy
            torch.cuda.empty_cache()

            # ---- MLP
            for batch, ln_res in ((2, False), (PREDICT_BATCH, True)):
                x, a, kw = _mlp_case(gen, batch, grid, c, ln_res, ln_res)
                got = kmlp.fused_mlp(x, **a, **kw)
                want = kmlp.fused_mlp_plain(x, **a, **kw)
                torch.cuda.synchronize()
                _compare(f"K2 grid {grid}^3 x{batch}, C={c}, ln+res {ln_res}",
                         got, want, k2)
                del got, want
            _timed(k2, "fused_mlp", "predict", PREDICT_BATCH, grid, c, nh,
                   lambda: kmlp.fused_mlp(x, **a, **kw),
                   lambda: kmlp.fused_mlp_plain(x, **a, **kw), 10)
            del x, a, kw
            # the training step's form (LN in the kernel, shortcut outside)
            # comes last and is the one timed
            for batch, res in ((2, True), (TRAIN_BATCH, True),
                               (TRAIN_BATCH, False)):
                x, a, kw = _mlp_case(gen, batch, grid, c, True, res)
                if batch == 2:
                    x = x[:-5].contiguous()  # a ragged last tile
                case = f"grid {grid}^3 x{batch}, C={c}, ln True, res {res}"
                if batch == TRAIN_BATCH and not res:
                    got = kmlp.fused_mlp(x, **a, **kw)
                    want = kmlp.fused_mlp_plain(x, **a, **kw)
                    torch.cuda.synchronize()
                    _compare("K2 " + case, got, want, k2)
                dy = torch.randn(x.shape, generator=gen,
                                 device="cuda").to(x.dtype)
                b = dict(w1=a["w1"], b1=a["b1"], w2=a["w2"], ln=kw["ln"],
                         dy=dy, residual=res)
                got = kmlp.fused_mlp_bwd(x, **b)
                want = kmlp.fused_mlp_bwd_plain(x, **b)
                torch.cuda.synchronize()
                _compare_grads("K4 " + case, K4_NAMES, got, want, k4)
                del got, want
            _timed(k2, "fused_mlp", "train", TRAIN_BATCH, grid, c, nh,
                   lambda: kmlp.fused_mlp(x, **a, **kw),
                   lambda: kmlp.fused_mlp_plain(x, **a, **kw), 10)
            _timed(k4, "fused_mlp_bwd", "train", TRAIN_BATCH, grid, c, nh,
                   lambda: kmlp.fused_mlp_bwd(x, **b),
                   lambda: kmlp.fused_mlp_bwd_plain(x, **b), 5)
            del x, a, b, kw, dy
            torch.cuda.empty_cache()
    # one launch at each of the four stages: the forward kernels at the
    # predictor call's shape (as measured since the first slice), the
    # backward kernels at the training step's
    for k, path in ((k1, "predict"), (k2, "predict"), (k3, "train"),
                    (k4, "train")):
        stages = [s for s in k["per_stage"] if s["path"] == path]
        for key in ("ms", "plain_ms", "bound_ms"):
            k[key] = sum(s[key] for s in stages)
        ops = sum(s["flops"] for s in stages) / PEAK_BF16_FLOPS
        mem = sum(s["bytes"] for s in stages) / PEAK_HBM_BYTES
        k["bound_by"] = "operations" if ops >= mem else "bytes"
        k["launches"] = 0
        del k["tag"]
    return [k1, k2, k3, k4]


FLAGSHIP_ARGS = ["--model", "nnFormerUNETR", "--vol_size", "96",
                 "--patch_size", "2", "--hidden_dim", "48", "--window_size",
                 "6", "--output_dim", "14", "--t_fixed_ct_intensity",
                 "--batch_size_val", "16", "--save_eval_output"]

# full model, bf16 with the kernels on the card vs fp32 plain on the CPU:
# activations round to bf16 (2^-9 relative) at every one of ~60 layers and
# InstanceNorm re-scales the error at each decoder stage; independent
# roundings add in quadrature to a few per cent of the logits' norm
MODEL_REL_TOL = 5e-2


def phase_model():
    """The full-width flagship on one 96^3 window: bf16 + kernels on the card
    against fp32 + plain on the CPU, same seeded weights and input."""
    import copy

    import torch

    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.models.factory import build_model, init_weights

    cfg = get_args(FLAGSHIP_ARGS)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = init_weights(build_model(cfg), gen)
    # the JAX initialisers (dense std 0.02) leave attention and MLP outputs
    # near zero; wider weights make every kernel matter to the logits
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("qkv.weight", "proj.weight", "fc1.weight",
                              "fc2.weight")):
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
            elif name.endswith("relative_position_bias_table"):
                p.normal_(0.0, 0.5, generator=gen)
            elif name.startswith("encoder") and name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=gen)
    model.eval()
    ref = copy.deepcopy(model)
    ref.dtype = torch.float32
    vol = torch.randn(1, 96, 96, 96, 1, generator=gen)
    x_in = (vol, torch.full((1, 3), 0.5), torch.ones(1, 3))

    with torch.inference_mode():
        t0 = time.perf_counter()
        want = ref(x_in)
        cpu_s = time.perf_counter() - t0
        gpu = model.to("cuda")
        x_gpu = tuple(t.to("cuda") for t in x_in)
        got = gpu(x_gpu)
        torch.cuda.synchronize()
        _require(got.shape == (1, 96, 96, 96, 14) and got.dtype == torch.float32,
                 f"model: logits {tuple(got.shape)} {got.dtype}")
        _require(bool(torch.isfinite(got).all()), "model: non-finite logits")
        got = got.cpu()
        rel = float((got - want).norm() / want.norm())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        print(f"model: full flagship 96^3, bf16+kernels (card) vs fp32 plain "
              f"(CPU, {cpu_s:.1f} s): rel norm err {rel:.3e} "
              f"(tol {MODEL_REL_TOL}), argmax agreement {agree:.4f}",
              flush=True)
        _require(rel <= MODEL_REL_TOL, "model: bf16 card logits disagree "
                 "with the fp32 CPU reference")
        xb = tuple(torch.cat([t] * 16) for t in x_gpu)
        ms = _time_ms(lambda: gpu(xb), 3)
        print(f"model: forward of 16 windows (one predictor call) "
              f"{ms:.1f} ms", flush=True)
    del model, ref, gpu
    torch.cuda.empty_cache()


def _ct_volume(rng, shape):
    """A CT-like volume in HU: air around an elliptic body of soft tissue,
    two brighter organs and a bony ring, with noise."""
    import numpy as np

    grids = np.meshgrid(*[np.linspace(-1, 1, s, dtype=np.float32)
                          for s in shape], indexing="ij")
    r2 = (grids[0] / 0.9) ** 2 + (grids[1] / 0.7) ** 2
    img = np.full(shape, -1000.0, np.float32)
    img[r2 < 1] = 40.0
    img[(r2 < 0.85) & (r2 > 0.7)] = 700.0
    for cx, cy, cz, hu in ((0.2, 0.1, 0.0, 120.0), (-0.3, -0.2, 0.3, 80.0)):
        blob = ((grids[0] - cx) ** 2 + (grids[1] - cy) ** 2
                + (grids[2] - cz) ** 2) < 0.05
        img[blob] = hu
    return img + rng.normal(0, 20, size=shape).astype(np.float32)


def phase_cli():
    """The prediction CLI on two synthetic CT volumes; the kernels' launch
    counts must be 8 per predictor call (8 Swin blocks)."""
    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.cli import run_test
    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.data import nifti

    shapes = ((240, 240, 140), (200, 180, 120))
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        task = os.path.join(tmp, "Task01_SmokeCT")
        os.makedirs(os.path.join(task, "imagesTs"))
        for i, shape in enumerate(shapes):
            nifti.save(nifti.NiftiImage(_ct_volume(rng, shape),
                                        np.diag([0.8, 0.8, 2.5, 1.0])),
                       os.path.join(task, "imagesTs", f"img{i}.nii.gz"))
        with open(os.path.join(task, "dataset.json"), "w") as f:
            json.dump({"training": [], "test": [
                f"./imagesTs/img{i}.nii.gz" for i in range(len(shapes))]}, f)
        out_dir = os.path.join(tmp, "out")
        cfg = get_args(FLAGSHIP_ARGS + [
            "--data_path", tmp, "--task", "Task01_SmokeCT",
            "--output_dir", out_dir, "--device", "cuda"])

        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        records = run_test.main(cfg)
        wall = time.perf_counter() - t0
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated()

        calls = sum(r["predictor_calls"] for r in records)
        _require(len(records) == len(shapes) and calls > 0,
                 f"cli: {len(records)} volumes, {calls} predictor calls")
        for name, want in (("window_attention", 8 * calls),
                           ("fused_mlp", 8 * calls),
                           ("window_attention_bwd", 0), ("fused_mlp_bwd", 0)):
            _require(launches[name] == want,
                     f"cli: {name} launched {launches[name]} times for "
                     f"{calls} predictor calls (want {want})")
        for i, shape in enumerate(shapes):
            path = os.path.join(out_dir, "test_output", "Fold0", "pred",
                                f"{i}.nii.gz")
            _require(os.path.exists(path), f"cli: no prediction {path}")
            pred = nifti.load(path).data
            _require(pred.shape == shape, f"cli: pred {pred.shape} != {shape}")
            _require(pred.dtype == np.uint8 and int(pred.max()) < 14,
                     "cli: pred labels out of range")
        for r in records:
            print(f"cli: {r['name']} {r['shape']}: {r['windows']} windows, "
                  f"{r['predictor_calls']} predictor calls, predicted in "
                  f"{r['predict_seconds']:.2f} s, written in "
                  f"{r['seconds']:.2f} s", flush=True)
        print(f"cli: {len(records)} volumes in {wall:.2f} s, peak device "
              f"memory {peak / 2 ** 30:.2f} GiB, launches {launches}",
              flush=True)
    return launches


def _reset_launches():
    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    kwa.launches = kwa.bwd_launches = kmlp.launches = kmlp.bwd_launches = 0


def _read_launches():
    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    return {"window_attention": kwa.launches, "fused_mlp": kmlp.launches,
            "window_attention_bwd": kwa.bwd_launches,
            "fused_mlp_bwd": kmlp.bwd_launches}


TRAIN_ARGS = ["--model", "nnFormerUNETR", "--vol_size", "96", "--patch_size",
              "2", "--hidden_dim", "48", "--window_size", "6", "--output_dim",
              "14", "--warmup_epochs", "0", "--device", "cuda"]
TRAIN_STEPS = 6

# gradients of one step at batch 8 on the same weights, batch and DropPath
# draws, as relative error norms. The limits are about 2.5 times what an
# NVIDIA H100 80GB HBM3 at 700 W gave.
# - Whole gradient, bf16 with the kernels against fp32 with the plain
#   versions (cuDNN and matmuls without TF32): every activation and kernel
#   intermediate rounds to bf16 (2^-9 relative) through ~60 layers forward
#   and back (measured 7.0e-3).
# - Whole gradient, the kernels against their plain versions, both bf16: only
#   the order of fp32 sums differs (measured 1.1e-3).
# - Each Swin block on its own: the block's input is taken from the model's
#   forward, a seeded cotangent stands for the rest of the network, and the
#   block's output, input gradient and every parameter gradient with the
#   kernels are held against the plain versions (measured at most 6.6e-4,
#   a stage-4 bias table). Inside the whole model the
#   same comparison says little about a deep block: there a change of 2e-3
#   relative in the input image alone moves the gradients of stage 1 by 9 %
#   and those of stage 4 by 33 %, parameters without any kernel included.
TRAIN_GRAD_BATCH = 8
TRAIN_GRAD_REL_TOL = 2e-2
TRAIN_KERNEL_GRAD_REL_TOL = 3e-3
TRAIN_BLOCK_REL_TOL = 2e-3
# the same batch at every step: each loss below the one before, and the last
# at most this share of the first
TRAIN_LOSS_FALL = 0.75


def _train_batch(gen, batch, n_classes, device="cuda"):
    """Crops whose labels follow the image: smooth random blobs, the class is
    the quantised blob value, the image the value plus noise."""
    import torch
    import torch.nn.functional as F

    coarse = torch.rand(batch, 1, 12, 12, 12, generator=gen, device=device)
    field = F.interpolate(coarse, size=(96, 96, 96), mode="trilinear",
                          align_corners=False)[:, 0]
    label = torch.clamp((field * n_classes).long(), 0, n_classes - 1)
    image = field + 0.05 * torch.randn(field.shape, generator=gen,
                                       device=device)
    return {"image": image[..., None].contiguous(), "label": label,
            "crop_loc": torch.full((batch, 3), 0.5, device=device),
            "affine": torch.ones(batch, 3, device=device)}


class _plain_kernels:
    """Inside the block the port's four wrappers are their plain versions, so
    that the fp32 reference of the train phase can run on the card."""

    def __enter__(self):
        from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
        from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

        self.saved = [(kwa, "window_attention", kwa.window_attention),
                      (kwa, "window_attention_bwd", kwa.window_attention_bwd),
                      (kmlp, "fused_mlp", kmlp.fused_mlp),
                      (kmlp, "fused_mlp_bwd", kmlp.fused_mlp_bwd)]
        kwa.window_attention = kwa.window_attention_plain
        kwa.window_attention_bwd = kwa.window_attention_bwd_plain
        kmlp.fused_mlp = kmlp.fused_mlp_plain
        kmlp.fused_mlp_bwd = kmlp.fused_mlp_bwd_plain

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _train_setup():
    import torch

    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
    from medicalsemseg_tpu_torch.train.state import (create_train_state,
                                                     make_train_step)

    cfg = get_args(TRAIN_ARGS)
    model = init_weights(build_model(cfg),
                         torch.Generator().manual_seed(cfg.seed)).to("cuda")
    state = create_train_state(cfg, model, steps_per_epoch=TRAIN_STEPS)
    return cfg, model, state, make_train_step(cfg)


def phase_train():
    """A few full-width training steps at batch 8, then one step's gradients
    against the fp32 plain path."""
    import torch

    from medicalsemseg_tpu_torch.models.layers import DropPath
    from medicalsemseg_tpu_torch.models.swin import SwinBlock
    from medicalsemseg_tpu_torch.train.losses import build_loss

    cfg, model, state, train_step = _train_setup()
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = _train_batch(gen, TRAIN_BATCH, cfg.output_dim)

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        _require(all(bool(torch.isfinite(v).all()) for v in m.values()),
                 f"train: non-finite metrics at step {len(losses) - 1}")
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"train: batch {TRAIN_BATCH} x 96^3, bf16, {TRAIN_STEPS} steps: "
          f"loss {' '.join(f'{v:.4f}' for v in losses)}; grad_norm "
          f"{float(m['grad_norm']):.3f}", flush=True)
    print(f"train: ms per step {' '.join(f'{t:.0f}' for t in times)} "
          f"(first includes cuDNN's choice of algorithms), peak device "
          f"memory {peak / 2 ** 30:.2f} GiB, launches {launches}", flush=True)
    _require(all(b < a for a, b in zip(losses, losses[1:]))
             and losses[-1] <= TRAIN_LOSS_FALL * losses[0],
             f"train: the loss did not fall at every step to "
             f"{TRAIN_LOSS_FALL} of the first: {losses}")
    for name, n in launches.items():
        _require(n == 8 * TRAIN_STEPS, f"train: {name} launched {n} times in "
                 f"{TRAIN_STEPS} steps (want {8 * TRAIN_STEPS})")

    # one step's gradients: bf16 + kernels vs fp32 + plain
    del state, m
    loss_fn = build_loss(cfg)
    small = {k: v[:TRAIN_GRAD_BATCH] for k, v in batch.items()}

    def seed_drop_path(net, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        for mod in net.modules():
            if isinstance(mod, DropPath):
                mod.generator = g

    def grads_of(net):
        seed_drop_path(net, 7)
        net.train()
        logits = net((small["image"], small["crop_loc"], small["affine"]))
        loss = loss_fn(logits, small["label"])
        grads = torch.autograd.grad(loss, list(net.parameters()))
        return float(loss.detach()), [g.float() for g in grads]

    inputs = {}
    hooks = [blk.register_forward_pre_hook(
        lambda mod, args, name=name: inputs.__setitem__(name, args[0].detach()))
        for name, blk in model.named_modules() if isinstance(blk, SwinBlock)]
    got_loss, got = grads_of(model)
    for h in hooks:
        h.remove()
    _require(len(inputs) == 8, f"train: {len(inputs)} Swin blocks found")
    with _plain_kernels():
        mid_loss, mid = grads_of(model)

    def block_grads(blk, x):
        seed_drop_path(blk, 11)
        x = x.clone().requires_grad_()
        y = blk(x)
        cot = torch.randn(y.shape, device="cuda", dtype=y.dtype,
                          generator=torch.Generator(device="cuda").manual_seed(3))
        grads = torch.autograd.grad((y.float() * cot.float()).sum(),
                                    [x] + list(blk.parameters()))
        return [y.detach().float()] + [g.float() for g in grads]

    for name, x in inputs.items():
        blk = model.get_submodule(name)
        a = block_grads(blk, x)
        with _plain_kernels():
            b = block_grads(blk, x)
        labels = ["y", "dx"] + [n for n, _ in blk.named_parameters()]
        errs = {n: float((u - v).norm() / v.norm())
                for n, u, v in zip(labels, a, b)}
        worst = max(errs, key=errs.get)
        print(f"train: {name} alone (input {tuple(x.shape)}, shift "
              f"{blk.shift_size}), kernels vs plain, bf16: y {errs['y']:.3e}, "
              f"dx {errs['dx']:.3e}, worst of {len(errs) - 2} parameter "
              f"gradients {worst} {errs[worst]:.3e} (tol "
              f"{TRAIN_BLOCK_REL_TOL})", flush=True)
        _require(errs[worst] <= TRAIN_BLOCK_REL_TOL, f"train: {name}: {worst} "
                 f"with the kernels is off by {errs[worst]:.3e}")
        del a, b
    del inputs

    model.dtype = torch.float32     # the same weights, now the reference
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with _plain_kernels():
            want_loss, want = grads_of(model)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    ref_peak = torch.cuda.max_memory_allocated()

    for label, b, b_loss, tol in (
            ("bf16 plain", mid, mid_loss, TRAIN_KERNEL_GRAD_REL_TOL),
            ("fp32 plain", want, want_loss, TRAIN_GRAD_REL_TOL)):
        num = torch.sqrt(sum(((u - v) ** 2).sum() for u, v in zip(got, b)))
        rel = float(num / torch.sqrt(sum((v ** 2).sum() for v in b)))
        print(f"train: gradients of one step (batch {TRAIN_GRAD_BATCH}), "
              f"bf16+kernels vs {label}: loss {got_loss:.5f} vs {b_loss:.5f}, "
              f"rel norm err {rel:.3e} (tol {tol})", flush=True)
        _require(rel <= tol, f"train: the gradients with the kernels "
                 f"disagree with the {label} path")
    print(f"train: peak device memory of the fp32 plain reference "
          f"{ref_peak / 2 ** 30:.2f} GiB", flush=True)
    del model, got, mid, want
    torch.cuda.empty_cache()
    return launches


def phase_profile():
    """torch.profiler over one warm training step at batch 8: device time by
    kernel name, for PERF.md's "where the time goes"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg, model, state, train_step = _train_setup()
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = _train_batch(gen, TRAIN_BATCH, cfg.output_dim)
    for _ in range(2):
        train_step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_step(state, batch)
        torch.cuda.synchronize()
    def device_us(e):  # the attribute's name changed between releases
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)

    rows = sorted(((device_us(e) / 1e3, e.count, e.key)
                   for e in prof.key_averages() if device_us(e) > 0
                   and e.device_type.name == "CUDA"), reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile: one training step, batch {TRAIN_BATCH}: {total:.1f} ms "
          f"of device kernel time in {len(rows)} kernels", flush=True)
    for ms, count, key in rows[:40]:
        print(f"  {ms:9.2f} ms {100 * ms / total:5.1f} %  x{count:<4d} "
              f"{key[:110]}", flush=True)
    del model, state
    torch.cuda.empty_cache()


def _write_train_set(task_dir, n, shape, n_classes, rng):
    """A synthetic Decathlon training folder: CT-like volumes with labelled
    blobs of every class."""
    import numpy as np

    from medicalsemseg_tpu_torch.data import nifti

    os.makedirs(os.path.join(task_dir, "imagesTr"))
    os.makedirs(os.path.join(task_dir, "labelsTr"))
    grids = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                        indexing="ij")
    training = []
    for i in range(n):
        img = _ct_volume(rng, shape)
        lab = np.zeros(shape, np.uint8)
        for c in range(1, n_classes):
            centre = [rng.uniform(0.25, 0.75) * s for s in shape]
            r = rng.uniform(8, 14)
            blob = sum((g - m) ** 2 for g, m in zip(grids, centre)) < r * r
            lab[blob] = c
            img[blob] = 40.0 + 25.0 * c
        aff = np.diag([1.0, 1.0, 1.5, 1.0])
        nifti.save(nifti.NiftiImage(img.astype(np.int16), aff),
                   os.path.join(task_dir, "imagesTr", f"img{i}.nii.gz"))
        nifti.save(nifti.NiftiImage(lab, aff),
                   os.path.join(task_dir, "labelsTr", f"img{i}.nii.gz"))
        training.append({"image": f"./imagesTr/img{i}.nii.gz",
                         "label": f"./labelsTr/img{i}.nii.gz"})
    with open(os.path.join(task_dir, "dataset.json"), "w") as f:
        json.dump({"training": training, "test": []}, f)


def phase_train_cli():
    """The training CLI: 2 epochs of 2 steps at batch 8 with validation and
    checkpoints every epoch, then a resumed third epoch."""
    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.cli import run_training
    from medicalsemseg_tpu_torch.config import get_args

    n_vol, shape = 20, (128, 120, 100)   # fold 0 of 5: 16 train, 4 val
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        _write_train_set(os.path.join(tmp, "Task02_SmokeTrain"), n_vol, shape,
                         14, rng)
        out = os.path.join(tmp, "out")
        os.makedirs(out)
        argv = TRAIN_ARGS + [
            "--data_path", tmp, "--task", "Task02_SmokeTrain", "--output_dir",
            out, "--log_dir", os.path.join(tmp, "log"),
            "--t_fixed_ct_intensity", "--t_rand_crop_fgbg", "--t_flip_prob",
            "0.2", "--t_spatial_pad", "--val_interval", "1", "--save_ckpt_freq",
            "1", "--metric_readback_freq", "1"]

        def log():
            with open(os.path.join(out, "log.txt")) as f:
                return [json.loads(line) for line in f]

        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        result = run_training.main(get_args(argv + ["--epochs", "2"]))
        wall = time.perf_counter() - t0
        launches = _read_launches()
        rows = log()
        _require([r["epoch"] for r in rows] == [0, 1],
                 f"train_cli: log.txt epochs {[r['epoch'] for r in rows]}")
        for r in rows:
            _require(all(k in r and np.isfinite(r[k]) for k in
                         ("train/loss", "train/mDice", "val/loss", "val/mDice")),
                     f"train_cli: log.txt row {r}")
        files = sorted(f for f in os.listdir(out) if f.endswith(".pth"))
        _require("checkpoint-1.pth" in files and "checkpoint-0.pth" not in files,
                 f"train_cli: checkpoint files {files}")
        steps = 2 * (16 // TRAIN_BATCH)
        payload = torch.load(os.path.join(out, "checkpoint-1.pth"),
                             weights_only=True)
        _require(payload["epoch"] == 1 and payload["step"] == steps,
                 f"train_cli: checkpoint epoch {payload['epoch']} step "
                 f"{payload['step']} (want 1, {steps})")
        for name in ("window_attention_bwd", "fused_mlp_bwd"):
            _require(launches[name] == 8 * steps, f"train_cli: {name} launched "
                     f"{launches[name]} times in {steps} steps")
        for name in ("window_attention", "fused_mlp"):
            _require(launches[name] > 8 * steps and launches[name] % 8 == 0,
                     f"train_cli: {name} launched {launches[name]} times "
                     f"(training steps and validation calls, 8 each)")
        print(f"train_cli: 2 epochs ({steps} steps at batch {TRAIN_BATCH}, 2 "
              f"validations of 4 volumes) in {wall:.1f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
              f"losses {[round(r['train/loss'], 4) for r in rows]}, val mDice "
              f"{[round(r['val/mDice'], 4) for r in rows]}, best "
              f"{result['best_val_metric']:.4f}, files {files}, launches "
              f"{launches}", flush=True)

        run_training.main(get_args(argv + [
            "--epochs", "3", "--resume", os.path.join(out, "checkpoint-1.pth")]))
        rows = log()
        _require([r["epoch"] for r in rows] == [0, 1, 2],
                 f"train_cli: after --resume, epochs {[r['epoch'] for r in rows]}")
        payload = torch.load(os.path.join(out, "checkpoint-2.pth"),
                             weights_only=True)
        _require(payload["step"] == steps + steps // 2 and payload["epoch"] == 2,
                 f"train_cli: resumed checkpoint step {payload['step']}")
        print(f"train_cli: --resume continued at epoch 2, step "
              f"{payload['step']}, loss {rows[-1]['train/loss']:.4f}",
              flush=True)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not os.path.isdir(os.path.join(REPO, "medicalsemseg_tpu_torch")):
        print("chip_smoke: medicalsemseg_tpu_torch not found beside this "
              "script; run it from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2

    kernels = []
    try:
        if "card" in phases:
            phase_card()
        if "build" in phases:
            phase_build()
        if "kernels" in phases:
            kernels = phase_kernels()
        if "model" in phases:
            phase_model()
        # the main paths: each is driven with the counts at 0 and read after
        for name, phase in (("cli", phase_cli), ("train", phase_train),
                            ("train_cli", phase_train_cli)):
            if name in phases:
                launches = phase()
                for k in kernels:
                    k[f"launches_{name}"] = launches[k["name"]]
                    k["launches"] += launches[k["name"]]
        if "profile" in phases:
            phase_profile()
        if set(PHASES) <= set(phases):
            for k in kernels:
                _require(k["launches"] > 0, f"{k['name']} was launched no "
                         "time on the main paths")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                           "orbax", "medicalsemseg_tpu"))
    if leaked:
        print(f"chip_smoke: jax or the JAX package was imported: "
              f"{leaked[:5]}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
