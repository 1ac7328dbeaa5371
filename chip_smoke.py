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
                 the FLOP and byte counts give; K5 (3^3 conv weight gradient)
                 at the full-resolution decoder shapes for batch 1 to 8 and a
                 ragged shape, beside cuDNN's weight gradient; K8 (fused
                 DiceCE, forward sums and dlogits) at batch 4 and 8 of 96^3 x
                 14 classes and a voxel count that is no multiple of its tile;
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
  7. train_b4  - the same model at batch 4 with --grad_accum_steps 2 and
                 --fused_loss, where the three full-resolution convs take K5
                 for their weight gradient and the loss K8: micro-steps
                 through make_train_step (loss, launch counts, ms, peak
                 memory), one micro-step's gradients against the fp32 plain
                 path and against cuDNN's weight gradient with the unfused
                 loss, and the micro-step timed with and without each kernel;
  8. train_cli - the training CLI on a synthetic Decathlon folder: 2 epochs,
                 validation, checkpoints, then a --resume run; an epoch at
                 batch 4 with accumulation and the fused loss, and a run that
                 starts from its checkpoint's encoder with --pretrained.
`--phases profile` (not run by default) prints torch.profiler tables of one
training step at batch 8 and one micro-step at batch 4. Then one JSON line with the kernels' numbers, and last the line
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
PHASES = ("card", "build", "kernels", "model", "cli", "train", "train_b4",
          "train_cli")
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
            ("K4", "fused_mlp_bwd", "mlp_bwd.cu", "mlp.py:276"),
            ("K5", "dw27", "dw27.cu", "dw27.py:114"),
            # forward sums :137 and the backward call inside _fused_for :176
            ("K8", "dice_ce_sums", "dice_ce.cu", "dice_ce.py:137"),
            ("K8", "dice_ce_dlogits", "dice_ce.cu", "dice_ce.py:176"))
    return {name: {"tag": tag, "name": name, "route": "cuda",
                   "source": src + cu, "replaces": ref + at,
                   "library_ms": None, "per_stage": []}
            for tag, name, cu, at in rows}


K3_NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias", "dln")
K4_NAMES = ("dx", "dln", "dw1", "db1", "dw2", "db2")


def phase_kernels():
    """Every kernel against its plain version at the shapes the main paths
    give it; the list of their reports, in the order K1-K5, K8."""
    rep = _kernel_reports()
    _swin_kernels(rep)
    _dw27_kernel(rep["dw27"])
    _dice_ce_kernels(rep["dice_ce_sums"], rep["dice_ce_dlogits"])
    for k in rep.values():
        k["launches"] = 0
        del k["tag"]
    return list(rep.values())


def _swin_kernels(rep):
    """K1-K4 against their plain versions at every flagship stage, at the
    shapes of the two main paths: one predictor call (16 windows of 96^3)
    and one training step (batch 8)."""
    import torch

    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    gen = torch.Generator(device="cuda").manual_seed(0)
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


# K5 and K8 against plain. Both sides multiply the same numbers (products of
# bf16 values are exact in fp32) and add them in fp32, so only the order of
# the sums differs. A sum of M = 3.5e6 products of unit scale is ~2e3 large;
# added in runs of ~6e4 terms it gathers ~1e-2 of fp32 rounding noise, 1e-5
# of its size (K5's tensor-core kernel flushes its accumulators every few
# tiles for that reason: the tensor cores add by truncation, and one chain
# over a block's whole share drifts to 2e-4). Limit: the error's norm within
# 1e-4 of the reference's; an NVIDIA H100 80GB HBM3 gave at most 2.1e-6.
SUM_NORM_TOL = 1e-4
# K8's dlogits are elementwise in fp32 from another exp and another order of
# the 14-term class sums: a few fp32 ulps of p, more where p - t cancels.
DLOGITS_NORM_TOL = 1e-5
# K5 (fp32) against cuDNN's weight gradient, which returns bf16: one rounding
# to bf16 is 2^-9 = 2e-3 of the norm, and cuDNN's result carries more than
# that at the larger shapes (3.2e-3 at batch 8, 96 -> 48, on an NVIDIA H100
# 80GB HBM3, while K5 stays within 2e-6 of the fp32 plain version there).
# The limit is about 2.5 times what that card gave.
LIBRARY_REL_TOL = 8e-3
PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 outside the tensor cores

CROP = 96                 # the training crop's edge
TRAIN_B4_BATCH = 4        # crops per micro-step of the batch-4 path
DW27_CONVS = ((48, 48), (96, 48))   # (C, Co) of the full-resolution 3^3 convs
# per micro-step: unet_encoders[0].layer.conv2 and unet_decoders[0]
# .conv_block.conv2 are 48 -> 48, unet_decoders[0].conv_block.conv1 96 -> 48
DW27_CALLS = {(48, 48): 2, (96, 48): 1}
N_CLASSES = 14


def _compare_sums(name, got, want, report, tol=SUM_NORM_TOL):
    import torch

    _require(got.shape == want.shape and got.dtype == want.dtype,
             f"{name}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    _require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    max_err = float((got - want).abs().max())
    rel = float((got - want).norm() / want.norm())
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), max_err)
    report["max_rel_err"] = max(report.get("max_rel_err", 0.0), rel)
    ok = rel <= tol
    print(f"  {name}: rel norm err {rel:.3e} (tol {tol}), max_abs_err "
          f"{max_err:.3e} of max|ref| {float(want.abs().max()):.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    _require(ok, f"{name}: kernel disagrees with its plain version")


def _bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _dw27_kernel(k5r):
    """K5 against dw27_plain, and timed beside cuDNN's weight gradient, at
    the shapes of the three full-resolution convs."""
    import torch

    from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5

    gen = torch.Generator(device="cuda").manual_seed(5)
    bf = torch.bfloat16

    def case(shape, c, co):
        x = torch.randn(*shape, c, generator=gen, device="cuda").to(bf)
        dy = torch.randn(*shape, co, generator=gen, device="cuda").to(bf)
        return x, dy

    def check(name, x, dy):
        got = k5.dw27(x, dy)
        torch.cuda.synchronize()
        _compare_sums(name, got, k5.dw27_plain(x, dy), k5r)
        _require(torch.equal(got, k5.dw27(x, dy)),
                 f"{name}: a second run is not bit-equal")

    with torch.inference_mode():
        x, dy = case((2, 5, 9, 13), 16, 24)
        check("K5 ragged 2x5x9x13, 16->24", x, dy)
        # batch 1: under the gate's window; 2 and 4: inside; 8: over it
        # (one call all the same: the kernel makes no copies to bound)
        for batch in (1, 2, 4, 8):
            for c, co in DW27_CONVS:
                x, dy = case((batch, CROP, CROP, CROP), c, co)
                name = f"K5 {batch}x{CROP}^3, {c}->{co}"
                if batch > 1:
                    check(name, x, dy)
                xn, dyn = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
                wshape = (co, c, 3, 3, 3)
                lib = torch.nn.grad.conv3d_weight(xn, wshape, dyn, padding=1)
                got = k5.dw27(x, dy).permute(4, 3, 0, 1, 2)
                lib_rel = float((got - lib.float()).norm() / got.norm())
                ms = _time_ms(lambda: k5.dw27(x, dy), 5)
                lms = _time_ms(lambda: torch.nn.grad.conv3d_weight(
                    xn, wshape, dyn, padding=1), 5)
                pms = (_time_ms(lambda: k5.dw27_plain(x, dy), 2)
                       if batch == TRAIN_B4_BATCH else None)
                m = batch * CROP ** 3
                flops = 2 * 27 * m * c * co
                nbytes = m * (c + co) * 2 + 27 * c * co * 4
                bound, by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
                k5r["per_stage"].append({
                    "C": c, "Co": co, "batch": batch, "ms": ms,
                    "plain_ms": pms, "library_ms": lms, "flops": flops,
                    "bytes": nbytes, "bound_ms": bound, "bound_by": by,
                    "rel_err_vs_library": lib_rel})
                print(f"  {name}: kernel {ms:.3f} ms, cuDNN wgrad {lms:.3f} "
                      f"ms (dW differs by {lib_rel:.2e} of the norm), plain "
                      f"{'-' if pms is None else f'{pms:.1f}'} ms, bound "
                      f"{bound:.4f} ms by {by} ({flops:.3e} FLOP, "
                      f"{nbytes:.3e} B)", flush=True)
                _require(lib_rel <= LIBRARY_REL_TOL, f"{name}: K5 and cuDNN's "
                         "weight gradient disagree")
                del x, dy, xn, dyn, lib, got
                torch.cuda.empty_cache()
    # one micro-step of the batch-4 path: its three calls
    main = {(s["C"], s["Co"]): s for s in k5r["per_stage"]
            if s["batch"] == TRAIN_B4_BATCH}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        k5r[key] = sum(n * main[conv][key] for conv, n in DW27_CALLS.items())
    k5r["bound_by"] = main[(48, 48)]["bound_by"]


def _dice_ce_kernels(fwd, bwd):
    """K8 forward sums and dlogits against their plain versions at the
    logits of the batch-4 micro-step and of a batch-8 step."""
    import torch

    from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8

    gen = torch.Generator(device="cuda").manual_seed(8)
    c = N_CLASSES
    with torch.inference_mode():
        for b, m in ((3, 100003), (8, CROP ** 3), (TRAIN_B4_BATCH, CROP ** 3)):
            logits = torch.randn(b, m, c, generator=gen, device="cuda") * 2.0
            labels = torch.randint(0, c, (b, m), generator=gen, device="cuda")
            name = f"{b}x{m}x{c}"
            got = k8.dice_ce_sums(logits, labels)
            torch.cuda.synchronize()
            want = k8.dice_ce_sums_plain(logits, labels)
            _compare_sums(f"K8 sums {name}", got, want, fwd)
            _require(torch.equal(got[:, 2], want[:, 2]),
                     f"K8 sums {name}: class voxel counts differ")
            _require(torch.equal(got, k8.dice_ce_sums(logits, labels)),
                     f"K8 sums {name}: a second run is not bit-equal")
            # the coefficients the loss's backward would pass (smooth 1e-5)
            dd = want[:, 1] + want[:, 2] + 1e-5
            ca = (-2.0 / dd / (b * c)).contiguous()
            cp = (2.0 * (2.0 * want[:, 0] + 1e-5) / (dd * dd) / (b * c)
                  ).contiguous()
            ce = torch.full((1,), 1.0 / (b * m), device="cuda")
            dl = k8.dice_ce_dlogits(logits, labels, ca, cp, ce)
            torch.cuda.synchronize()
            _compare_sums(f"K8 dlogits {name}", dl,
                          k8.dice_ce_dlogits_plain(logits, labels, ca, cp, ce),
                          bwd, DLOGITS_NORM_TOL)
            del dl, got, want
            if m != CROP ** 3:
                continue
            nin = b * m * (c * 4 + labels.element_size())
            for rep, fn, plain, nbytes, flops in (
                    (fwd, lambda: k8.dice_ce_sums(logits, labels),
                     lambda: k8.dice_ce_sums_plain(logits, labels),
                     nin + b * 4 * c * 4, 10 * b * m * c),
                    (bwd, lambda: k8.dice_ce_dlogits(logits, labels, ca, cp, ce),
                     lambda: k8.dice_ce_dlogits_plain(logits, labels, ca, cp,
                                                      ce),
                     nin + b * m * c * 4 + 2 * b * c * 4, 14 * b * m * c)):
                ms, pms = _time_ms(fn, 10), _time_ms(plain, 5)
                bound, by = _bound(flops, nbytes, PEAK_FP32_FLOPS)
                rep["per_stage"].append({
                    "batch": b, "ms": ms, "plain_ms": pms, "flops": flops,
                    "bytes": nbytes, "bound_ms": bound, "bound_by": by})
                print(f"  K8 {rep['name']} {name}: kernel {ms:.3f} ms, plain "
                      f"{pms:.3f} ms, bound {bound:.4f} ms by {by} "
                      f"({flops:.3e} FLOP, {nbytes:.3e} B)", flush=True)
            del logits, labels
            torch.cuda.empty_cache()
    for rep in (fwd, bwd):    # the batch-4 micro-step's call, measured last
        rep.update({k: rep["per_stage"][-1][k]
                    for k in ("ms", "plain_ms", "bound_ms", "bound_by")})


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
        _require_launches(f"cli ({calls} predictor calls)", launches, {
            **dict.fromkeys(launches, 0), "window_attention": 8 * calls,
            "fused_mlp": 8 * calls})
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
    from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8
    from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5
    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    kwa.launches = kwa.bwd_launches = kmlp.launches = kmlp.bwd_launches = 0
    k5.launches = k8.launches = k8.bwd_launches = 0


def _read_launches():
    from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8
    from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5
    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    return {"window_attention": kwa.launches, "fused_mlp": kmlp.launches,
            "window_attention_bwd": kwa.bwd_launches,
            "fused_mlp_bwd": kmlp.bwd_launches, "dw27": k5.launches,
            "dice_ce_sums": k8.launches, "dice_ce_dlogits": k8.bwd_launches}


SWIN_KERNELS = ("window_attention", "fused_mlp", "window_attention_bwd",
                "fused_mlp_bwd")


def _require_launches(phase, launches, want):
    for name, n in want.items():
        _require(launches[name] == n, f"{phase}: {name} launched "
                 f"{launches[name]} times (want {n})")


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
    """Inside the block the port's wrappers are their plain versions, so
    that the fp32 reference of the train phases can run on the card."""

    def __enter__(self):
        from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8
        from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5
        from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
        from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

        names = ((kwa, "window_attention"), (kwa, "window_attention_bwd"),
                 (kmlp, "fused_mlp"), (kmlp, "fused_mlp_bwd"), (k5, "dw27"),
                 (k8, "dice_ce_sums"), (k8, "dice_ce_dlogits"))
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in names]
        for mod, name in names:
            setattr(mod, name, getattr(mod, name + "_plain"))

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _train_setup(extra_args=()):
    import torch

    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
    from medicalsemseg_tpu_torch.train.state import (create_train_state,
                                                     make_train_step)

    cfg = get_args(TRAIN_ARGS + list(extra_args))
    model = init_weights(build_model(cfg),
                         torch.Generator().manual_seed(cfg.seed)).to("cuda")
    state = create_train_state(cfg, model, steps_per_epoch=TRAIN_STEPS)
    return cfg, model, state, make_train_step(cfg)


def _seed_drop_path(net, seed):
    import torch

    from medicalsemseg_tpu_torch.models.layers import DropPath

    g = torch.Generator(device="cuda").manual_seed(seed)
    for mod in net.modules():
        if isinstance(mod, DropPath):
            mod.generator = g


def _grads_of(net, loss_fn, batch):
    """Loss and fp32 copies of every parameter gradient of one training-mode
    forward and backward, with the DropPath draws seeded."""
    import torch

    _seed_drop_path(net, 7)
    net.train()
    logits = net((batch["image"], batch["crop_loc"], batch["affine"]))
    loss = loss_fn(logits, batch["label"])
    grads = torch.autograd.grad(loss, list(net.parameters()))
    return float(loss.detach()), [g.float() for g in grads]


def _fp32_plain_grads(model, grads_of):
    """(loss, gradients, peak bytes) of ``grads_of(model)`` with the model
    switched to fp32, every kernel swapped for its plain version and TF32
    off: the reference of the train phases. The model stays fp32."""
    import torch

    model.dtype = torch.float32     # the same weights, now the reference
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with _plain_kernels():
            loss, grads = grads_of(model)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return loss, grads, torch.cuda.max_memory_allocated()


def _rel_norm(got, want):
    """Error norm over a list of tensors, relative to the reference's."""
    import torch

    num = torch.sqrt(sum(((u - v) ** 2).sum() for u, v in zip(got, want)))
    return float(num / torch.sqrt(sum((v ** 2).sum() for v in want)))


def phase_train():
    """A few full-width training steps at batch 8, then one step's gradients
    against the fp32 plain path."""
    import torch

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
    # 8 Swin blocks per step; batch 8 of 96^3 is 7.08M voxels, over the
    # window of K5's gate, and the loss is the unfused one
    _require_launches(f"train ({TRAIN_STEPS} steps)", launches, {
        **dict.fromkeys(launches, 0),
        **dict.fromkeys(SWIN_KERNELS, 8 * TRAIN_STEPS)})

    # one step's gradients: bf16 + kernels vs fp32 + plain
    del state, m
    loss_fn = build_loss(cfg)
    small = {k: v[:TRAIN_GRAD_BATCH] for k, v in batch.items()}

    def grads_of(net):
        return _grads_of(net, loss_fn, small)

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
        _seed_drop_path(blk, 11)
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

    want_loss, want, ref_peak = _fp32_plain_grads(model, grads_of)
    for label, b, b_loss, tol in (
            ("bf16 plain", mid, mid_loss, TRAIN_KERNEL_GRAD_REL_TOL),
            ("fp32 plain", want, want_loss, TRAIN_GRAD_REL_TOL)):
        rel = _rel_norm(got, b)
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


TRAIN_B4_FLAGS = ["--n_images_per_batch", str(TRAIN_B4_BATCH),
                  "--grad_accum_steps", "2", "--fused_loss"]
TRAIN_B4_MICRO = 6      # micro-steps: three optimizer updates
# One micro-step's gradients with K5 and K8 against the same step with
# MEDSEG_DW27_PALLAS=0 and the unfused loss, both bf16 with K1-K4, as
# relative error norms. K5 rounds an fp32 sum to bf16 once; cuDNN's bf16
# result is 2-3e-3 from the fp32 sum at these shapes (LIBRARY_REL_TOL above).
# The limits are about 2.5 times what an NVIDIA H100 80GB HBM3 at 700 W gave:
# the three convs' dW 9.3e-4, 2.5e-3 and 1.0e-3, the whole gradient (which
# adds the fused loss's fp32 dlogits against autograd's) 9.2e-4.
TRAIN_B4_CONV_REL_TOL = 6e-3
TRAIN_B4_ALT_REL_TOL = 2.5e-3
B4_CONVS = ("unet_encoders.0.layer.conv2.conv.weight",
            "unet_decoders.0.conv_block.conv1.conv.weight",
            "unet_decoders.0.conv_block.conv2.conv.weight")


class _dw27_mode:
    """MEDSEG_DW27_PALLAS set to ``mode`` (None: unset, the auto gate)
    inside the block."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        self.saved = os.environ.pop("MEDSEG_DW27_PALLAS", None)
        if self.mode is not None:
            os.environ["MEDSEG_DW27_PALLAS"] = self.mode

    def __exit__(self, *exc):
        os.environ.pop("MEDSEG_DW27_PALLAS", None)
        if self.saved is not None:
            os.environ["MEDSEG_DW27_PALLAS"] = self.saved


def phase_train_b4():
    """Batch 4 with accumulation over 2 micro-steps and the fused loss: the
    path on which the three full-resolution convs take K5 and the loss K8."""
    import torch

    from medicalsemseg_tpu_torch.train.losses import build_loss
    from medicalsemseg_tpu_torch.train.state import make_train_step

    cfg, model, state, train_step = _train_setup(TRAIN_B4_FLAGS)
    unfused_cfg = cfg.replace(fused_loss=False)
    unfused_step = make_train_step(unfused_cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = _train_batch(gen, TRAIN_B4_BATCH, cfg.output_dim)
    n = TRAIN_B4_MICRO

    with _dw27_mode(None):
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        losses, times = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = train_step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            _require(all(bool(torch.isfinite(v).all()) for v in m.values()),
                     f"train_b4: non-finite metrics at micro-step "
                     f"{len(losses) - 1}")
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated()
    per_update = [sum(losses[i:i + 2]) / 2 for i in range(0, n, 2)]
    print(f"train_b4: batch {TRAIN_B4_BATCH} x 96^3, bf16, grad_accum_steps "
          f"2, fused loss, {n} micro-steps ({state.updates} updates): loss "
          f"{' '.join(f'{v:.4f}' for v in losses)}; grad_norm "
          f"{float(m['grad_norm']):.3f}", flush=True)
    print(f"train_b4: ms per micro-step {' '.join(f'{t:.0f}' for t in times)} "
          f"(first includes cuDNN's choice of algorithms; every second one "
          f"ends with the optimizer update), peak device memory "
          f"{peak / 2 ** 30:.2f} GiB, launches {launches}", flush=True)
    _require(state.updates == n // 2, f"train_b4: {state.updates} updates")
    # the same batch throughout: the weights change after every second
    # micro-step, and the mean loss of each pair is below the pair before
    _require(all(b < a for a, b in zip(per_update, per_update[1:])),
             f"train_b4: the loss did not fall after every update: {losses}")
    _require_launches(f"train_b4 ({n} micro-steps)", launches, {
        **dict.fromkeys(SWIN_KERNELS, 8 * n), "dw27": 3 * n,
        "dice_ce_sums": n, "dice_ce_dlogits": n})

    # the micro-step with and without each kernel, in the order A, B, B, A;
    # two micro-steps (one update) per reading, each route warmed first
    def ms_per_micro(step, mode):
        with _dw27_mode(mode):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                step(state, batch)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 2

    ms_per_micro(train_step, "0")
    ms_per_micro(unfused_step, None)
    for what, a, b in (
            ("K5 (auto gate) vs MEDSEG_DW27_PALLAS=0, fused loss both",
             (train_step, None), (train_step, "0")),
            ("K8 (--fused_loss) vs the unfused loss, K5 both",
             (train_step, None), (unfused_step, None))):
        t = [ms_per_micro(*cfg_) for cfg_ in (a, b, b, a)]
        print(f"train_b4: ms per micro-step, {what}: A {t[0]:.1f}, B "
              f"{t[1]:.1f}, B {t[2]:.1f}, A {t[3]:.1f}", flush=True)
    del state, m

    # one micro-step's gradients on the weights as they are now
    fused, unfused = build_loss(cfg), build_loss(unfused_cfg)
    with _dw27_mode(None):
        before = _read_launches()
        got_loss, got = _grads_of(model, fused, batch)
        after = _read_launches()
    _require(after["dw27"] - before["dw27"] == 3
             and after["dice_ce_dlogits"] - before["dice_ce_dlogits"] == 1,
             "train_b4: the gradient step did not take K5 and K8")
    with _dw27_mode("0"):
        alt_loss, alt = _grads_of(model, unfused, batch)
    names = [name for name, _ in model.named_parameters()]
    for name in B4_CONVS:
        i = names.index(name)
        rel = _rel_norm([got[i]], [alt[i]])
        print(f"train_b4: {name} {tuple(got[i].shape)}: dW with K5 vs cuDNN's "
              f"weight gradient, rel norm err {rel:.3e} (tol "
              f"{TRAIN_B4_CONV_REL_TOL:.3e})", flush=True)
        _require(rel <= TRAIN_B4_CONV_REL_TOL, f"train_b4: {name}: K5's "
                 "weight gradient disagrees with cuDNN's")
    with _dw27_mode(None):
        want_loss, want, ref_peak = _fp32_plain_grads(
            model, lambda net: _grads_of(net, fused, batch))
    for label, b, b_loss, tol in (
            ("bf16 with cuDNN wgrad and the unfused loss", alt, alt_loss,
             TRAIN_B4_ALT_REL_TOL),
            ("fp32 plain", want, want_loss, TRAIN_GRAD_REL_TOL)):
        rel = _rel_norm(got, b)
        print(f"train_b4: gradients of one micro-step (batch "
              f"{TRAIN_B4_BATCH}), bf16+kernels vs {label}: loss "
              f"{got_loss:.5f} vs {b_loss:.5f}, rel norm err {rel:.3e} "
              f"(tol {tol})", flush=True)
        _require(rel <= tol, f"train_b4: the gradients with K5 and K8 "
                 f"disagree with the {label} path")
    print(f"train_b4: peak device memory of the fp32 plain reference "
          f"{ref_peak / 2 ** 30:.2f} GiB", flush=True)
    del model, got, alt, want
    torch.cuda.empty_cache()
    return launches


def phase_profile():
    """torch.profiler over one warm training step at batch 8 and one warm
    micro-step at batch 4 with the fused loss: device time by kernel name,
    for PERF.md's "where the time goes"."""
    with _dw27_mode(None):
        _profile_step(TRAIN_BATCH, ())
        _profile_step(TRAIN_B4_BATCH, TRAIN_B4_FLAGS)


def _profile_step(n_batch, extra_args):
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg, model, state, train_step = _train_setup(extra_args)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = _train_batch(gen, n_batch, cfg.output_dim)
    for _ in range(2):      # with accumulation over 2 micro-steps the profiled
        train_step(state, batch)  # call is the first of a pair: no update
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
    print(f"profile: one training step, batch {n_batch} "
          f"{' '.join(extra_args)}: {total:.1f} ms "
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
    checkpoints every epoch, then a resumed third epoch; then one epoch of 4
    micro-steps at batch 4 with accumulation and the fused loss, and a run
    with --pretrained on the checkpoint that epoch wrote."""
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
        base = TRAIN_ARGS + [
            "--data_path", tmp, "--task", "Task02_SmokeTrain",
            "--log_dir", os.path.join(tmp, "log"),
            "--t_fixed_ct_intensity", "--t_rand_crop_fgbg", "--t_flip_prob",
            "0.2", "--t_spatial_pad", "--val_interval", "1", "--save_ckpt_freq",
            "1", "--metric_readback_freq", "1"]
        argv = base + ["--output_dir", out]

        def log(out_dir=out):
            with open(os.path.join(out_dir, "log.txt")) as f:
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
        # batch 8: K5's gate is closed, and the loss is the unfused one
        _require_launches(f"train_cli ({steps} steps at batch 8)", launches, {
            "window_attention_bwd": 8 * steps, "fused_mlp_bwd": 8 * steps,
            "dw27": 0, "dice_ce_sums": 0, "dice_ce_dlogits": 0})
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

        # batch 4, accumulation over 2, fused loss: 16 volumes are 4
        # micro-steps and 2 updates; validation's masked loss stays unfused
        def b4_run(name, extra):
            out_dir = os.path.join(tmp, name)
            os.makedirs(out_dir)
            before = _read_launches()
            t0 = time.perf_counter()
            with _dw27_mode(None):
                run_training.main(get_args(
                    base + TRAIN_B4_FLAGS + ["--output_dir", out_dir,
                                             "--epochs", "1"] + extra))
            wall = time.perf_counter() - t0
            after = _read_launches()
            delta = {k: after[k] - before[k] for k in after}
            micro = 16 // TRAIN_B4_BATCH
            _require_launches(f"train_cli {name} ({micro} micro-steps)", delta, {
                "window_attention_bwd": 8 * micro, "fused_mlp_bwd": 8 * micro,
                "dw27": 3 * micro, "dice_ce_sums": micro,
                "dice_ce_dlogits": micro})
            row = log(out_dir)[-1]
            _require(all(np.isfinite(row[k]) for k in
                         ("train/loss", "train/mDice", "val/loss", "val/mDice")),
                     f"train_cli {name}: log.txt row {row}")
            payload = torch.load(os.path.join(out_dir, "checkpoint-0.pth"),
                                 weights_only=True)
            _require(payload["step"] == micro and payload["updates"] == micro // 2,
                     f"train_cli {name}: checkpoint step {payload['step']}, "
                     f"updates {payload['updates']}")
            print(f"train_cli: {name}: 1 epoch ({micro} micro-steps at batch "
                  f"{TRAIN_B4_BATCH}, {micro // 2} updates, 1 validation) in "
                  f"{wall:.1f} s, loss {row['train/loss']:.4f}, val mDice "
                  f"{row['val/mDice']:.4f}, launches {delta}", flush=True)
            return payload["model"]

        first = b4_run("b4", [])
        # --pretrained: another seed and a learning rate of 0, so the
        # encoder this run ends with is the one it was given, bit for bit,
        # and the decoder is its own
        second = b4_run("b4_pretrained", [
            "--pretrained", os.path.join(tmp, "b4", "checkpoint-0.pth"),
            "--seed", "5", "--lr", "0"])
        enc = [k for k in first if k.startswith("encoder.")]
        _require(len(enc) > 100 and all(torch.equal(first[k], second[k])
                                        for k in enc),
                 "train_cli: --pretrained did not load the file's encoder")
        _require(any(not torch.equal(first[k], second[k]) for k in first
                     if not k.startswith("encoder.")),
                 "train_cli: --pretrained also replaced the decoder")
        print(f"train_cli: --pretrained loaded {len(enc)} encoder tensors "
              "from the batch-4 run's checkpoint", flush=True)
    return _read_launches()


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
                            ("train_b4", phase_train_b4),
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
