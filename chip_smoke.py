#!/usr/bin/env python3
"""Smoke run of the PyTorch port (medicalsemseg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. card    - print the card's name and power limit (nvidia-smi);
  2. build   - build the CUDA kernels from csrc/ and print the build time;
  3. kernels - each kernel against its plain PyTorch version in bf16 at the
               four flagship stage shapes (batch 2, and batch 16 = one
               predictor call), with max abs error and times at batch 16;
  4. model   - the full-width flagship on one 96^3 window in bf16 with the
               kernels, against the same weights in fp32 on the CPU (plain);
  5. cli     - the label-free prediction CLI on two synthetic CT volumes,
               with the kernels' launch counts checked against the predictor
               calls.
Then one JSON line with the kernels' numbers, and last the line
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
PHASES = ("card", "build", "kernels", "model", "cli")

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


def _attn_case(gen, batch, grid, c, nh, shift, ln_res):
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
              residual=ln_res,
              ln=(torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                               0.1 * torch.randn(c, generator=gen, device=dev)])
                  if ln_res else None))
    return wins, args, kw


def _mlp_case(gen, batch, grid, c, ln_res):
    import torch

    dev, bf = "cuda", torch.bfloat16
    m = batch * grid ** 3
    x = torch.randn(m, c, generator=gen, device=dev).to(bf)
    args = dict(
        w1=(torch.randn(4 * c, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        b1=torch.randn(4 * c, generator=gen, device=dev) * 0.1,
        w2=(torch.randn(c, 4 * c, generator=gen, device=dev) * (4 * c) ** -0.5).to(bf),
        b2=torch.randn(c, generator=gen, device=dev) * 0.1)
    kw = dict(residual=ln_res,
              ln=(torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                               0.1 * torch.randn(c, generator=gen, device=dev)])
                  if ln_res else None))
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


def phase_kernels():
    """K1 and K2 against their plain versions at every flagship stage."""
    import torch

    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = {"name": "window_attention", "route": "cuda",
          "source": "medicalsemseg_tpu_torch/csrc/window_attention.cu",
          "replaces": "medicalsemseg_tpu/ops/pallas/window_attention.py:154",
          "per_stage": []}
    k2 = {"name": "fused_mlp", "route": "cuda",
          "source": "medicalsemseg_tpu_torch/csrc/mlp.cu",
          "replaces": "medicalsemseg_tpu/ops/pallas/mlp.py:84",
          "per_stage": []}
    with torch.inference_mode():
        for grid, c, nh in STAGES:
            # batch 2: every form; batch 16 (one predictor call of the main
            # path, sw_batch 16): the absorbed form, compared and timed
            for batch, shift, ln_res in ((2, 0, False), (2, WS // 2, True),
                                         (16, 0, True)):
                wins, a, kw = _attn_case(gen, batch, grid, c, nh, shift,
                                         ln_res)
                got = kwa.window_attention(wins, **a, **kw)
                want = kwa.window_attention_plain(wins, **a, **kw)
                torch.cuda.synchronize()
                _compare(f"K1 grid {grid}^3 x{batch}, C={c}, nh={nh}, shift "
                         f"{shift}, ln+res {ln_res}", got, want, k1)
                del got, want
            ms = _time_ms(lambda: kwa.window_attention(wins, **a, **kw), 10)
            pms = _time_ms(lambda: kwa.window_attention_plain(wins, **a, **kw), 10)
            k1["per_stage"].append({"C": c, "batch": 16, "ms": ms,
                                    "plain_ms": pms})
            print(f"  K1 grid {grid}^3 x16, C={c}: kernel {ms:.3f} ms, "
                  f"plain {pms:.3f} ms", flush=True)
            del wins, a, kw
            for batch, ln_res in ((2, False), (16, True)):
                x, a, kw = _mlp_case(gen, batch, grid, c, ln_res)
                got = kmlp.fused_mlp(x, **a, **kw)
                want = kmlp.fused_mlp_plain(x, **a, **kw)
                torch.cuda.synchronize()
                _compare(f"K2 grid {grid}^3 x{batch}, C={c}, ln+res {ln_res}",
                         got, want, k2)
                del got, want
            ms = _time_ms(lambda: kmlp.fused_mlp(x, **a, **kw), 10)
            pms = _time_ms(lambda: kmlp.fused_mlp_plain(x, **a, **kw), 10)
            k2["per_stage"].append({"C": c, "batch": 16, "ms": ms,
                                    "plain_ms": pms})
            print(f"  K2 grid {grid}^3 x16, C={c}: kernel {ms:.3f} ms, "
                  f"plain {pms:.3f} ms", flush=True)
            del x, a, kw
            torch.cuda.empty_cache()
    for k in (k1, k2):
        k["ms"] = sum(s["ms"] for s in k["per_stage"])
        k["plain_ms"] = sum(s["plain_ms"] for s in k["per_stage"])
    return [k1, k2]


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

    from medicalsemseg_tpu_torch.cli.run_test import get_args
    from medicalsemseg_tpu_torch.models.factory import build_model, init_weights

    cfg, _ = get_args(FLAGSHIP_ARGS)
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
    from medicalsemseg_tpu_torch.data.preprocess import nifti
    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

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
        cfg, device = run_test.get_args(FLAGSHIP_ARGS + [
            "--data_path", tmp, "--task", "Task01_SmokeCT",
            "--output_dir", out_dir, "--device", "cuda"])

        torch.cuda.reset_peak_memory_stats()
        kwa.launches = 0
        kmlp.launches = 0
        t0 = time.perf_counter()
        records = run_test.main(cfg, device)
        wall = time.perf_counter() - t0
        launches = {"window_attention": kwa.launches, "fused_mlp": kmlp.launches}
        peak = torch.cuda.max_memory_allocated()

        calls = sum(r["predictor_calls"] for r in records)
        _require(len(records) == len(shapes) and calls > 0,
                 f"cli: {len(records)} volumes, {calls} predictor calls")
        for name, n in launches.items():
            _require(n == 8 * calls, f"cli: {name} launched {n} times for "
                     f"{calls} predictor calls (want {8 * calls})")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
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
        if "cli" in phases:
            launches = phase_cli()
            for k in kernels:
                k["launches"] = launches[k["name"]]
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    if leaked:
        print(f"chip_smoke: jax was imported: {leaked[:5]}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
