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
                 the FLOP and byte counts give; K6 (GC-ViT global-query
                 attention) at the same four stages, K7 (SegFormer
                 spatial-reduction attention) at the four SegFormer3D stages
                 and K2 at GC-ViT's hidden width 3C, all at batch 16; K5 (3^3
                 conv weight gradient)
                 at the full-resolution decoder shapes for batch 1 to 8 and a
                 ragged shape, beside cuDNN's weight gradient; K8 (fused
                 DiceCE, forward sums and dlogits) at batch 4 and 8 of 96^3 x
                 14 classes and a voxel count that is no multiple of its
                 tile, there also with labels outside [0, C);
                 K9 (Winograd F(2^3, 3^3) conv) at the shapes of one
                 predictor call and of one training step, bare and with the
                 scale / shift / LeakyReLU epilogue, and K10 (im2col conv,
                 forward and dx) at the full-resolution shapes in bf16, and
                 in fp16 and fp32 at one of them, each beside the library's
                 conv, with K10 at 8 and 128 output channels and at 8 input
                 channels on small odd volumes (`--kernels conv` runs these
                 two alone);
                 and K1-K4, K6, K7 in fp32 at their four stages beside an
                 fp32 bound (`--kernels fp32`). The heads launches of K1, K3
                 and K6, their GEMM launches (K1's and K6's projection, K3's
                 dx and dw), and K2 and K4, have a tensor-core and a
                 CUDA-core route: both are held against plain (K3's and K4's
                 tensor-core reruns bit-equal), and the CUDA-core route is
                 timed beside the route the dtype picks, with a reference
                 point that is not the kernel's function:
                 scaled_dot_product_attention on the same q, k, v for K1 and
                 K3, the composition layer_norm -> linear -> gelu -> linear
                 (+ x) in the compute dtype (forward, and forward and
                 backward by autograd) for K2 and K4; each launch of K1, K3
                 and K6 is also timed alone on both routes (torch.profiler)
                 beside its own bound and, for the GEMM launches, F.linear
                 (projection) or torch.matmul (dx: dqkv @ Wqkv; dw: the two
                 weight products on a precomputed xn); K7 has the same two
                 routes (the tensor cores' reruns bit-equal, both timed
                 also by torch.profiler, beside F.linear -> SDPA -> F.linear
                 + shortcut in bf16, a reference point);
  4. model     - the full-width flagship on one 96^3 window in bf16 with the
                 kernels, against the same weights in fp32 on the CPU (plain);
  5. zoo       - GCViTUNETR, SegFormer3D and SwinSegFormer at full width: one
                 96^3 window in bf16 with the kernels against fp32 on the
                 CPU, the launch counts of one predictor call of 16 windows,
                 its time with the kernels and with their plain versions
                 swapped in, and peak memory;
  6. cli       - the label-free prediction CLI on two synthetic CT volumes,
                 with the kernels' launch counts checked against the
                 predictor calls; then --model GCViTUNETR, --model SegFormer3D
                 and the flagship with --tta_mirror on the smaller volume;
  7. train     - the full-width flagship, batch 8 of 96^3, bf16: a few steps
                 through make_train_step (loss finite and falling, launch
                 counts, ms per step, peak memory), and one step's gradients
                 against the fp32 plain path on the same weights, and each
                 Swin block on its own with the kernels against plain;
  8. train_b4  - the same model at batch 4 with --grad_accum_steps 2 and
                 --fused_loss, where the three full-resolution convs take K5
                 for their weight gradient and the loss K8: micro-steps
                 through make_train_step (loss, launch counts, ms, peak
                 memory), one micro-step's gradients against the fp32 plain
                 path and against cuDNN's weight gradient with the unfused
                 loss, and the micro-step timed with and without each kernel;
  9. train_cli - the training CLI on a synthetic Decathlon folder: 2 epochs,
                 validation, checkpoints, then a --resume run; an epoch at
                 batch 4 with accumulation and the fused loss, and a run that
                 starts from its checkpoint's encoder with --pretrained;
 10. fused     - the paths that run K9 without gradients: one predictor call
                 of the flagship with MEDSEG_FUSED_DECODER=1 and with
                 MEDSEG_WINOGRAD=1 (logits against fp32 on the CPU and
                 against the ungated card path, K9's launches as the gate
                 requires, A/B/B/A times, peak memory), one GCViTUNETR call
                 and the prediction CLI with the fused decoder;
 11. train_wino - a few steps at batch 8 with MEDSEG_WINOGRAD_TRAIN=1 (K9 for
                 the forward and dx of every eligible conv): launches per
                 step from the gate, one step's gradients against fp32 plain
                 and against the ungated step, ms per step beside ungated;
 12. conv3d    - the function conv3x3x3 (K10 forward and dx, dW through K5)
                 at the full-resolution shapes, batch 4, then at 8 input
                 channels in bf16, fp16 and fp32 and at 48 in fp16 and fp32:
                 value and gradients against autograd through the library's
                 conv (fp32 without TF32), the launches by route, and times;
 13. fp32      - --compute_dtype float32 through the kernels: the prediction
                 CLI on one volume (labels against the plain versions), two
                 training steps through the training CLI at batch 2, one
                 predictor call's logits and one step's gradients against
                 the fp32 plain path, and one --compute_dtype float16 call;
 14. eval      - the labelled evaluation CLI on two synthetic CT volumes
                 with 13 seeded organ labels (14 classes) with --device_hd95
                 (8 K1 and 8 K2 launches per predictor call; per-volume
                 seconds), host HD95 of three organ classes of the smaller
                 volume bit-equal to the CLI's, then the fold majority-vote
                 CLI over three fold directories against majority_vote_np;
 15. f5        - the shapes that no kernel took before (fault F5):
                 SegFormer3D at --vol_size 160 through the predictor (K7 on
                 its streaming CUDA-core route in all 8 blocks; logits
                 against the fp32 plain path; one call of 16 windows timed)
                 and one flagship training step at --hidden_dim 96, batch 2
                 (K1-K4 in all 8 blocks, K3 and K4 on the CUDA cores at
                 stage 4, C = 768; gradients against the fp32 plain path);
 16. r15       - --num_heads 1 2 4 8 (head dim 48 at every stage): one
                 flagship predictor call (logits against the fp32 plain
                 path; K1's heads launches on their wide CUDA-core form) and
                 one training step at batch 2 (K1-K4 in all 8 blocks;
                 gradients against the fp32 plain path), then one
                 GCViTUNETR and one SegFormer3D predictor call (K1 / K6 and
                 K7 on the CUDA cores);
 17. zoo_train - GCViTUNETR, SegFormer3D and SwinSegFormer trained at full
                 width: 4 steps at batch 8 (every step's launches by
                 kernel and route, the loss falls, the BatchNorm running
                 statistics move, ms per step, peak memory), one step's
                 gradients against the fp32 plain path,
                 then the training CLI at that batch and at batch 4 with
                 --grad_accum_steps 2 --fused_loss (K8, and K5 in
                 GCViTUNETR's decoder);
 18. swin_opts - SwInception and SwinDepth at full width (bf16 card vs
                 fp32 CPU on one window, one predictor call of 16 windows:
                 K1 8, K2 0; 4 steps at batch 8, each block's attention
                 alone against plain, the whole gradient of a batch-2 step
                 against the bf16 plain control, the training CLI), the
                 flagship with --rel_pos_bias_affine --global_token (the
                 unfused attention: K1 0, K2 8 a call) and with the
                 embedding options (--learned_cls_vectors --lcv_final_layer
                 --rel_crop_pos_emb --abs_pos_emb --patch_size 2 2 1, through
                 the prediction CLI), 4 steps of each
                 option set at batch 2, and one SwInception step under
                 MEDSEG_DW27_PALLAS=1 MEDSEG_WINOGRAD_TRAIN=1 with every K5
                 and K9 launch held against cuDNN's wgrad / F.conv3d;
 19. zoo_official - the official nnFormer, VideoSwinUNETR and
                 SwinUNETR_Official at full width: one window bf16 card vs
                 fp32 CPU, one predictor call of 16 windows with every K1 and
                 K2 launch held against its plain version (K1 11 and K2 14
                 for nnFormer, 8 and 8 for VideoSwinUNETR and for
                 SwinUNETR_Official with MEDSEG_OFFICIAL_FUSED=1, six of its
                 K1 launches on the CUDA cores at 7^3 = 343-token windows;
                 none without the gate), the prediction CLI on a 200x180x120
                 CT volume (nnFormer also with --ref_quirk_rel_pos,
                 SwinUNETR_Official with the gate on and off), nnFormer's
                 labelled evaluation with --device_hd95, and each model's
                 training: 4 steps at batch 8 (nnFormer with
                 --deep_supervision: K3 11, K4 14 a step; the MONAI blocks
                 train plain, as in JAX), nnFormer's attentions alone
                 against plain and the whole gradient of its batch-2 step
                 against the bf16 plain control, the training CLI at batch 8
                 and nnFormer's at batch 4 with --grad_accum_steps 2
                 --fused_loss (K8 for each of its three heads);
 20. zoo_rest  - FocalNetUNETR and UNETR_Official (ViT-B) at 96^3 and
                 LRGFormerUNETR at 64^3 (it fails at 96 in the JAX package,
                 so the port raises there), full width: one window bf16
                 card vs fp32 CPU, one predictor call of 16 windows with
                 every K2 launch held against its plain version (K2 8 a
                 FocalNet call, 12 a UNETR_Official call at (3456, 768,
                 3072), none in LRGFormer), the prediction CLI on a
                 200x180x120 CT volume (FocalNetUNETR also with
                 MEDSEG_FUSED_DECODER=1), 4 training steps at batch 8 (the
                 MLPs train plain, as in JAX: no launch), the whole gradient
                 of a batch-2 step against fp32 plain and the training CLI
                 at batch 8; LRGFormerUNETR's predictor call at vol 128
                 (33,281 tokens a window at stage 1) against fp32 on the
                 card with its peak memory; Swin2D through build_model (16
                 images of 384^2, patch 2, window 6): forward and gradient
                 against fp32 on the card;
 21. dist      - data parallelism on the one card: the full-width flagship's
                 step on 4 crops (bf16, no DropPath) by two ranks (child
                 processes of this script, gloo on CUDA tensors, DDP, 2
                 crops a rank) against one process on the same crops: loss,
                 grad norm and the parameters after the update; K1-K4 8
                 launches and K5 3 on each rank; what NCCL does with two
                 ranks on one card; the same step by one NCCL rank through
                 DDP (in this process); the prediction CLI at world size 2
                 (one volume a rank) against the cli phase's labels, voxel
                 for voxel;
 22. profile_dir - one epoch of two steps (batch 2) through the training
                 CLI with --profile_dir: the Chrome trace names the kernels
                 of K1-K4, device_memory_stats() a peak above 0;
 23. device_pipeline - the device-resident crop pipeline's first batch on
                 the card against the same loader's on the CPU (equal
                 without normalisation, within 1e-6 with channel
                 normalisation), then two epochs through the training CLI
                 with --device_data_pipeline;
 24. remat     - block rematerialisation, and MEDSEG_WINOGRAD=1 in fp32:
                 the flagship at batch 8 of 96^3 in bf16 with drop path
                 0.2, one step's loss and gradients under --remat conv,
                 mixed and full against two runs under none (within twice
                 their spread, at least 1e-5 relative), then ms per step,
                 peak memory and K1-K4 launches by route under each mode;
                 batch 16 under full and mixed (must fit); SwInception at
                 batch 2, its BatchNorm running statistics after one step
                 under conv against none; one fp32 predictor call of two
                 windows with MEDSEG_WINOGRAD=1 (its 3^3 convs without
                 TF32, counted) against the unset call (logits within 1e-2,
                 A/B/B/A ms).
Every training phase runs the default --remat conv, as the JAX package
does: each Swin block of the Swin UNETR models runs its forward again in
the backward, so K1 and K2 launch twice a block and step (REMAT_FORWARDS).
The kernels group `f5` (in the default set) holds the same paths' kernels at
their shapes against their plain versions, timed: K7's streaming route at
SegFormer3D's four stages at vol 160 (M = 125) and at stage 4 with
M = 216 / 512 (batch 16, bf16); K1 and K3 at the four stages of hidden 96
and K2 and K4 at C = 768 (batch 2, bf16); K2's CUDA-core route at C = 768
in fp32. The group `r15` holds K1, K3 (every output), K6 and K7 at head
dims 48 and 96 (the stages of hidden 48 and 96 with heads 1 2 4 8, batch 2,
K7 at vol 96 and 160) in bf16 and fp32 against their plain versions, reruns
bit-equal, timed beside their bounds and SDPA. The group `official` holds
K1 at SwinUNETR_Official's four stages of one predictor call with the gate on
(343-token windows on padded grids 49^3, 28^3, 14^3 on the CUDA cores, the
clamped 6^3 window at stage 4 on the tensor cores; unshifted and shifted,
the unshifted timed beside plain, its bound and SDPA) and at a clamped
anisotropic window with a zeroed shift (both routes). The group `zoo_rest`
holds K2 at ViT-B's shape of one UNETR_Official predictor call, (M, C, H) =
(3456, 768, 3072), in bf16 (tensor cores) and fp32 (CUDA cores) against its
plain version, timed beside its bound and the layer_norm -> linear -> gelu
-> linear composition, and times FocalNet's depthwise 6^3 and 8^3 convs at
16 x 48^3 x 48 on the contiguous layout (PyTorch's kernel) and the
channels-last view (cuDNN), forward and forward + backward.
`--phases zoo_grads` (not run by default) prints the whole-gradient readings
behind ZOO_GRAD_CTL_FACTOR and, for SwInception and SwinDepth, the block
controls behind holding their attention alone (`_swin_block_controls`);
`--phases profile_official` (not run by default) prints torch.profiler tables
of one training step at batch 8 and one predictor call of each zoo_official
model (SwinUNETR_Official's call also with MEDSEG_OFFICIAL_FUSED=1);
`--phases profile` (not run by default) prints torch.profiler tables of one
training step at batch 8 of the flagship, SwInception and SwinDepth, one
micro-step at batch 4, one predictor call of each zoo model, SwInception and
SwinDepth, and one of the flagship without and with the fused decoder;
`--phases k9_parts`, `--phases k5_parts`, `--phases k10_parts`, `--phases
attn_parts`, `--phases mlp_parts` and `--phases sr_parts` time K9, K5, K10's
tensor-core route, the tensor-core launches of K1 and K3, the tensor-core K2
and K4, and the tensor-core K7, built with one part or another compiled
out. The phases model, zoo, cli, train, train_b4,
train_cli and fp32 print the launches of K1, K3, K6, K2, K4 and K7 by route
and require the tensor cores on
the bf16 and fp16 paths, the CUDA cores on the fp32 ones, for the heads
and the GEMM launches alike; the kernels line carries the sums
(`launches_by_route`, `launches_by_gemm_route`). Then one JSON line with the
kernels' numbers, and
last the line
{"ok": true, "device": {...}}. Imports torch and the port, never jax.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("card", "build", "kernels", "model", "zoo", "cli", "train",
          "train_b4", "train_cli", "fused", "train_wino", "conv3d", "fp32",
          "eval", "f5", "r15", "zoo_train", "swin_opts", "zoo_official",
          "zoo_rest", "dist", "profile_dir", "device_pipeline", "remat")
# groups of the kernels phase, for --kernels
KERNEL_GROUPS = ("swin", "zoo", "dw27", "dice_ce", "conv", "fp32", "f5",
                 "r15", "official", "zoo_rest")
EXTRA_PHASES = ("profile", "k9_parts", "k5_parts", "k10_parts", "attn_parts",
                "mlp_parts", "sr_parts", "zoo_grads", "heads_forms",
                "profile_official")

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


def _queued_ms(fn, iters):
    """Device ms of one call of ``fn`` with the host's cost per call out of
    the way: a sleep kernel holds the stream while all ``iters`` calls are
    queued behind it, so the events time the calls back to back on the
    device (where each call costs the host more than the card, _time_ms
    times the host)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)    # ~2 ms at 1.98 GHz: longer than queuing
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _card_label():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_card():
    line = _card_label()
    print(line, flush=True)
    return line


def phase_build():
    from medicalsemseg_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.load()
    print(f"build: {kernels.library_path()} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _attn_case(gen, batch, grid, c, nh, shift, ln, res, dtype=None):
    import torch

    from medicalsemseg_tpu_torch.ops import window as tw

    dev, bf = "cuda", dtype or torch.bfloat16
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


def _mlp_case(gen, batch, grid, c, ln, res, ratio=4, dtype=None):
    import torch

    dev, bf = "cuda", dtype or torch.bfloat16
    m = batch * grid ** 3
    hid = ratio * c
    x = torch.randn(m, c, generator=gen, device=dev).to(bf)
    args = dict(
        w1=(torch.randn(hid, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        b1=torch.randn(hid, generator=gen, device=dev) * 0.1,
        w2=(torch.randn(c, hid, generator=gen, device=dev) * hid ** -0.5).to(bf),
        b2=torch.randn(c, generator=gen, device=dev) * 0.1)
    kw = dict(residual=res,
              ln=(torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                               0.1 * torch.randn(c, generator=gen, device=dev)])
                  if ln else None))
    return x, args, kw


def _compare(name, got, want, report, tol=KERNEL_ATOL):
    import torch

    _require(got.shape == want.shape and got.dtype == want.dtype,
             f"{name}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    _require(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    err = (g - w).abs()
    max_err = float(err.max())
    ok = bool((err <= tol + tol * w.abs()).all())
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), max_err)
    print(f"  {name}: max_abs_err {max_err:.3e} "
          f"(tol {tol} + {tol}*|ref|) {'ok' if ok else 'FAIL'}", flush=True)
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


def _compare_grads(name, names, got, want, report, norm_tol=None,
                   max_tol=None):
    import torch

    norm_tol = GRAD_NORM_TOL if norm_tol is None else norm_tol
    max_tol = GRAD_MAX_TOL if max_tol is None else max_tol
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
        ok = rel <= norm_tol and max_err <= max_tol * scale
        if nm == "dx":
            report["max_abs_err"] = max(report.get("max_abs_err", 0.0), max_err)
        report["max_rel_err"] = max(report.get("max_rel_err", 0.0), rel)
        print(f"  {name} {nm}: rel norm err {rel:.3e} (tol {norm_tol}), "
              f"max_abs_err {max_err:.3e} of max|ref| {scale:.3e} "
              f"(tol {max_tol}) {'ok' if ok else 'FAIL'}", flush=True)
        _require(ok, f"{name} {nm}: kernel disagrees with its plain version")


# Published peaks of one H100 SXM at its full power limit of 700 W (NVIDIA's
# data sheet): dense bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _work(kind, t, n, c, nh, elem=2):
    """(FLOPs, bytes) of one call on T windows of N tokens (M = T * N rows):
    every product of the function once, every input read once, every output
    written once (activations and weights of ``elem`` bytes, fp32 biases,
    bias table and weight gradients)."""
    m = t * n
    act = m * c * elem
    if kind == "window_attention":      # qkv, proj; q k^T and p v per head
        return (8 * m * c * c + 4 * t * n * n * c,
                2 * act + 4 * c * c * elem + 4 * c * 4 + 2 * c * 4
                + nh * n * n * 4)
    if kind == "window_attention_bwd":  # qkv, dout, dWproj, dx, dWqkv;
        # s, o, dp, dv, dq, dk per head
        return (22 * m * c * c + 12 * t * n * n * c,
                3 * act + 4 * c * c * (elem + 4) + 4 * c * (4 + 4) + 2 * c * 8
                + nh * n * n * 8)
    if kind == "fused_mlp":             # fc1, fc2 with hidden 4C
        return (16 * m * c * c,
                2 * act + 8 * c * c * elem + 5 * c * 4 + 2 * c * 4)
    if kind == "fused_mlp_bwd":         # h, dW2, da, dW1, dxn
        return (40 * m * c * c,
                3 * act + 8 * c * c * (elem + 4) + 5 * c * 8 + 2 * c * 8)
    raise ValueError(kind)


def _bound_ms(kind, t, n, c, nh, elem=2, peak=None):
    flops, nbytes = _work(kind, t, n, c, nh, elem)
    peak = peak or PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return flops, nbytes, max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                                else "bytes")


PREDICT_BATCH = 16   # windows per predictor call of the prediction path
TRAIN_BATCH = 8      # crops per training step


def _timed(report, kind, label, batch, grid, c, nh, fn, plain_fn, iters,
           elem=2, peak=None, extra=None):
    """Time kernel and plain version (CUDA events) and put the stage's
    numbers, with the FLOP and byte counts behind its bound, into report;
    ``extra`` names further calls on the same tensors to time beside them
    (``<name>_ms``)."""
    t = batch * (grid // WS) ** 3
    ms = _time_ms(fn, iters)
    pms = _time_ms(plain_fn, iters)
    flops, nbytes, bound, by = _bound_ms(kind, t, WS ** 3, c, nh, elem, peak)
    stage = {"C": c, "batch": batch, "path": label, "ms": ms, "plain_ms": pms,
             "flops": flops, "bytes": nbytes, "bound_ms": bound,
             "bound_by": by}
    more = _extra_times(stage, extra, iters)
    report["per_stage"].append(stage)
    print(f"  {report['tag']} {label} grid {grid}^3 x{batch}, C={c}: kernel "
          f"{ms:.3f} ms, plain {pms:.3f} ms{more}, bound {bound:.4f} ms by "
          f"{by} ({flops:.3e} FLOP, {nbytes:.3e} B)", flush=True)


def _extra_times(stage, extra, iters):
    """Time each call of ``extra`` into ``stage[<name>_ms]``; the text for
    the stage's line."""
    more = ""
    for name, fn in (extra or {}).items():
        stage[f"{name}_ms"] = _time_ms(fn, iters)
        more += f", {name} {stage[f'{name}_ms']:.3f} ms"
    return more


# The heads launches of K1, K3 and K6 take the tensor cores in bf16 and fp16
# at head dim 16 (every stage of the flagship and the zoo) and the CUDA cores
# in fp32 (ops/kernels/window_attention.py, attention_route); K2 and K4 take
# them in bf16 and fp16 with widths in multiples of 16
# (ops/kernels/mlp.py, mlp_route, mlp_bwd_route), K7 in bf16 and fp16 at
# head dim 16 with M <= 64 (ops/kernels/sr_attention.py, sr_route). The
# kernels phase holds and times both routes on the same tensors; the model
# phases require the route their dtype picks.
ROUTE_TOTALS = {name: {"tensor_core": 0, "cuda_core": 0} for name in (
    "window_attention", "window_attention_bwd", "global_window_attention",
    "fused_mlp", "fused_mlp_bwd", "window_attention_gemm",
    "window_attention_bwd_gemm", "global_window_attention_gemm",
    "sr_attention", "conv3x3x3", "winograd_conv3d_f23")}
# the GEMM launches of K1, K3 and K6 (K1's and K6's projection, K3's dx and
# dw) have routes of their own (window_attention.gemm_route): the kernels
# line carries them as launches_by_gemm_route
GEMM_ROUTES = {"window_attention": "window_attention_gemm",
               "window_attention_bwd": "window_attention_bwd_gemm",
               "global_window_attention": "global_window_attention_gemm"}

# The launches of K1, K3 and K6 by kernel name: a kernel counts under the
# first label whose pattern its name holds (K6's launches carry K1's names).
ATTN_LAUNCHES = (("proj", "window_attention_proj"),
                 ("dx", "window_attention_bwd_dx"),
                 ("dw", "window_attention_bwd_dw"), ("heads", "heads"))


PROFILE_SESSIONS = 3


def _launch_times(fn, iters, launches=ATTN_LAUNCHES):
    """Device ms that one call of ``fn`` spends in each of its launches
    (``launches``: (label, pattern of the kernel's name)), from
    torch.profiler over ``iters`` warm calls (CPU and CUDA activities, as
    _profiled: with the CUDA activity alone, a session after such a one saw
    no kernel). A session that records no device activity of these launches
    is taken again, up to PROFILE_SESSIONS in all (once on the H100, a
    session among dozens in one process recorded no kernel of a launch that
    ran); raises where none sees a launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None) or getattr(
                e, "cuda_time_total", 0)
            if us <= 0 or e.device_type.name != "CUDA":
                continue
            for label, pattern in launches:
                if pattern in e.key:
                    out[label] = out.get(label, 0.0) + us / 1e3 / iters
                    break
        if out:
            return out
    raise PhaseError("the profiler saw no launch of " +
                     ", ".join(p for _, p in launches))


def _launch_work(kind, t, n, c, nh, ln=True, res=True, elem=2):
    """(FLOPs, bytes) of one launch of K1 or K3 on T windows of N tokens, as
    _work counts a whole call: every product once, every input read once,
    every output written once."""
    m = t * n
    act = m * c * elem
    lnb = 2 * c * 4 if ln else 0
    if kind == "heads":        # K1: qkv; q k^T and p v per head
        return (6 * m * c * c + 4 * t * n * n * c,
                2 * act + 3 * c * c * elem + 3 * c * 4 + lnb + nh * n * n * 4)
    if kind == "proj":         # attn (+ x) in, out
        return (2 * m * c * c,
                (3 if res else 2) * act + c * c * elem + c * 4)
    if kind == "bwd_heads":    # qkv, dout; s, o, dp, dv, dq, dk per head
        return (8 * m * c * c + 12 * t * n * n * c,
                6 * act + 4 * c * c * elem + 3 * c * 4 + lnb
                + 2 * nh * n * n * 4)
    if kind == "dx":           # dqkv (+ x, + dy) in, dx out, dLN
        return (6 * m * c * c,
                (4 + bool(ln) + bool(res)) * act + 3 * c * c * elem + 2 * lnb)
    if kind == "dw":           # dqkv, x, dy, o in; fp32 dW and db out
        return 8 * m * c * c, 6 * act + lnb + 4 * c * c * 4 + 4 * c * 4
    raise ValueError(kind)


def _launch_report(stage, tag, label, times, work, library):
    """Per-launch times of both routes beside each launch's bound and its
    library reference into ``stage["launches"]``, and a line."""
    stage["launches"] = {}
    for name, (flops, nbytes) in work.items():
        bound, by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
        row = {route: times[route].get(name, 0.0) for route in times}
        row.update(flops=flops, bytes=nbytes, bound_ms=bound, bound_by=by)
        if name in library:
            row["library_ms"] = _time_ms(library[name], 10)
        stage["launches"][name] = row
        lib = (f", library {row['library_ms']:.3f}" if name in library
               else "")
        print(f"  {tag} {label} C={stage['C']} {name} launch: tensor_core "
              f"{row['tensor_core']:.3f} ms, cuda_core {row['cuda_core']:.3f} "
              f"ms{lib}, bound {bound:.4f} ms by {by}", flush=True)


def _k1_launches(report, label, wins, a, kw, call=None):
    """K1 (or, with ``call``, K6) on these windows: the heads and projection
    launches timed separately on both routes, the projection beside
    F.linear on the same (M, C) attention output and weights."""
    import torch.nn.functional as F

    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    call = call or (lambda **r: kwa.window_attention(wins, **a, **kw, **r))
    t, n, c = wins.shape
    nh = a["bias"].shape[0]
    times = {route: _launch_times(lambda r=route: call(route=r, gemm_route=r),
                                  5) for route in kwa.ROUTES}
    attn = wins.reshape(t * n, c).clone()
    wp, bp = a["wproj"], a["bproj"].to(wins.dtype)
    work = {name: _launch_work(name, t, n, c, nh, kw["ln"] is not None,
                               kw["residual"]) for name in ("heads", "proj")}
    if "q_global" in a:  # K6 projects k and v only and reads the queries
        flops, nbytes = work["heads"]
        work["heads"] = (flops - 2 * t * n * c * c,
                         nbytes - c * c * 2 + a["q_global"].numel() * 2)
    _launch_report(report["per_stage"][-1], report["tag"], label, times, work,
                   {"proj": lambda: F.linear(attn, wp, bp)})


def _k3_launches(report, wins, b, kw, dy):
    """K3 on these windows: the heads, dx and dw launches timed separately
    on both routes, dx beside dqkv @ Wqkv and dw beside the two weight
    products dqkv^T @ xn and dy^T @ o on a precomputed xn (torch.matmul,
    cuBLAS)."""
    import torch

    from medicalsemseg_tpu_torch.ops import kernels
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    t, n, c = wins.shape
    nh = b["bias"].shape[0]
    times = {route: _launch_times(
        lambda r=route: kwa.window_attention_bwd(wins, dy=dy, **b, **kw,
                                                 route=r, gemm_route=r), 3)
        for route in kwa.ROUTES}
    m, dt = t * n, wins.dtype
    x2, dy2 = wins.reshape(m, c), dy.reshape(m, c)
    xn = (kernels.layer_norm(x2.float(), kw["ln"], 1e-5).to(dt)
          if kw["ln"] is not None else x2)
    dqkv = torch.randn(m, 3 * c, device="cuda").to(dt)
    o = torch.randn(m, c, device="cuda").to(dt)
    wq = b["wqkv"]
    work = {"heads": _launch_work("bwd_heads", t, n, c, nh,
                                  kw["ln"] is not None, kw["residual"]),
            **{name: _launch_work(name, t, n, c, nh, kw["ln"] is not None,
                                  kw["residual"]) for name in ("dx", "dw")}}
    _launch_report(report["per_stage"][-1], report["tag"], "train", times,
                   work, {"dx": lambda: torch.matmul(dqkv, wq),
                          "dw": lambda: (torch.matmul(dqkv.t(), xn),
                                         torch.matmul(dy2.t(), o))})


def _sdpa_reference(wins, a, kw, grad=False):
    """``scaled_dot_product_attention`` on the q, k, v of these windows (T,
    nh, N, 16) with the same additive fp32 bias (unshifted), and with it in
    the activations' dtype: a reference point for the heads launch alone
    (it leaves out the LayerNorm and both projections, so it is not the
    kernel's function and no path calls it). With ``grad``, its forward and
    backward for q, k, v. Returns {name: fn}."""
    import torch
    import torch.nn.functional as F

    from medicalsemseg_tpu_torch.ops import kernels
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    _require(all(s == 0 for s in kw["shift"]), "sdpa reference: unshifted only")
    dt = wins.dtype
    nh = a["bias"].shape[0]
    xn = (kernels.layer_norm(wins.float(), kw["ln"], 1e-5).to(dt)
          if kw["ln"] is not None else wins)
    with torch.no_grad():
        q, k, v = (u.to(dt).contiguous()
                   for u in kwa._qkv_heads(xn, a["wqkv"], a["bqkv"], nh))
    masks = {"sdpa": a["bias"][None], "sdpa_lowbias": a["bias"][None].to(dt)}
    if not grad:
        return {name: (lambda m=m: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=m)) for name, m in masks.items()}
    with torch.inference_mode(False):  # tensors autograd may save
        q, k, v = (u.clone().requires_grad_(True) for u in (q, k, v))
        do = torch.randn_like(q)
        masks = {name: m.clone() for name, m in masks.items()}

    def fwd_bwd(m):
        with torch.inference_mode(False), torch.enable_grad():
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=m)
            return torch.autograd.grad(out, (q, k, v), do)

    return {name: (lambda m=m: fwd_bwd(m)) for name, m in masks.items()}


def _sdpa_global_reference(wins, a, kw):
    """``scaled_dot_product_attention`` on K6's q (the batch element's
    query grid, scaled in fp32 and rounded), k and v (the windows' kv
    projection) with the same additive fp32 bias: a reference point for
    K6's heads launch, as :func:`_sdpa_reference` is for K1's (not K6's
    function). Returns {name: fn}."""
    import torch
    import torch.nn.functional as F

    from medicalsemseg_tpu_torch.ops import kernels

    dt = wins.dtype
    t, n, c = wins.shape
    nh = a["bias"].shape[0]
    hd = c // nh
    b = a["q_global"].shape[0]
    xn = (kernels.layer_norm(wins.float(), kw["ln"], 1e-5).to(dt)
          if kw["ln"] is not None else wins)
    with torch.no_grad():
        kv = xn.float() @ a["wkv"].float().t()
        if a["bkv"] is not None:
            kv = kv + a["bkv"].float()
        k, v = (u.to(dt).contiguous() for u in kv.reshape(
            t, n, 2, nh, hd).permute(2, 0, 3, 1, 4))
        q = (a["q_global"].float() * hd ** -0.5).to(dt).reshape(
            b, n, nh, hd).permute(0, 2, 1, 3).repeat_interleave(t // b, 0)
        q = q.contiguous()
    mask = a["bias"][None]
    # the scale is in q already
    return {"sdpa": lambda: F.scaled_dot_product_attention(q, k, v,
                                                           attn_mask=mask,
                                                           scale=1.0)}


def _mlp_reference(x, a, kw, grad=False):
    """layer_norm -> F.linear -> F.gelu -> F.linear [-> + x] on these tokens
    in their dtype (cuBLAS and PyTorch's own kernels): a reference point for
    K2 and, with ``grad``, its forward and backward by autograd for K4. It
    is the same function with other rounding points (h is stored in T, the
    LayerNorm is PyTorch's two-pass one), no single call computes it, and no
    path of the port calls it. Returns {"reference": fn}."""
    import torch
    import torch.nn.functional as F

    dt, c = x.dtype, x.shape[1]
    ln = kw["ln"]
    with torch.inference_mode(False):  # tensors autograd may save
        p = {"x": x.clone(), "w1": a["w1"].clone(), "w2": a["w2"].clone(),
             "b1": a["b1"].to(dt), "b2": a["b2"].to(dt)}
        if ln is not None:
            p["g"], p["b"] = ln[0].to(dt), ln[1].to(dt)
        if grad:
            p = {k: v.requires_grad_(True) for k, v in p.items()}
            dy = torch.randn_like(p["x"])

    def fwd():
        xn = (F.layer_norm(p["x"], (c,), p["g"], p["b"], 1e-5)
              if ln is not None else p["x"])
        y = F.linear(F.gelu(F.linear(xn, p["w1"], p["b1"])), p["w2"], p["b2"])
        return y + p["x"] if kw["residual"] else y

    if not grad:
        return {"reference": fwd}

    def fwd_bwd():
        with torch.inference_mode(False), torch.enable_grad():
            return torch.autograd.grad(fwd(), tuple(p.values()), dy)

    return {"reference": fwd_bwd}


def _read_routes():
    from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    return {"window_attention": dict(kwa.route_launches),
            "window_attention_bwd": dict(kwa.bwd_route_launches),
            "global_window_attention": dict(kga.route_launches),
            "fused_mlp": dict(kmlp.route_launches),
            "fused_mlp_bwd": dict(kmlp.bwd_route_launches),
            "window_attention_gemm": dict(kwa.gemm_route_launches),
            "window_attention_bwd_gemm": dict(kwa.bwd_gemm_route_launches),
            "global_window_attention_gemm": dict(kga.gemm_route_launches),
            "sr_attention": dict(ksr.route_launches)}


def _add_routes(phase, routes=None):
    """The launches by route since the last ``_reset_launches`` (or
    ``routes``, read so): print them, add them to ROUTE_TOTALS for the
    kernels line and return them."""
    routes = _read_routes() if routes is None else routes
    print(f"{phase}: launches by route "
          f"{ {k: v for k, v in routes.items() if any(v.values())} }",
          flush=True)
    for name, by in routes.items():
        for r, n in by.items():
            ROUTE_TOTALS[name][r] += n
    return routes


def _check_routes(phase, route, need=True, other_routes=None):
    """The launches of the kernels with two routes since the last
    ``_reset_launches`` all took ``route`` but for the counts of the other
    route that ``other_routes`` ({kernel: launches}) names (and, with
    ``need``, there was at least one on ``route``): print them and add them
    to ROUTE_TOTALS for the kernels line."""
    routes = _add_routes(phase)
    other = "cuda_core" if route == "tensor_core" else "tensor_core"
    for name, by in routes.items():
        want = (other_routes or {}).get(name, 0)
        _require(by[other] == want, f"{phase}: {name} took the {other} "
                 f"route {by[other]} times (want {want})")
    _require(not need or sum(by[route] for by in routes.values()) > 0,
             f"{phase}: no launch took the {route} route")


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
            # K6 shares K1's source file and its projection launch
            ("K6", "global_window_attention", "window_attention.cu",
             "window_attention.py:775"),
            ("K7", "sr_attention", "sr_attention.cu", "sr_attention.py:85"),
            # forward sums :137 and the backward call inside _fused_for :176
            ("K8", "dice_ce_sums", "dice_ce.cu", "dice_ce.py:137"),
            ("K8", "dice_ce_dlogits", "dice_ce.cu", "dice_ce.py:176"),
            ("K9", "winograd_conv3d_f23", "winograd3d.cu",
             "winograd3d.py:212"),
            # forward :113, which is also dx; its dW :164 is K5's function
            ("K10", "conv3x3x3", "conv3d.cu", "conv3d.py:113"))
    return {name: {"tag": tag, "name": name, "route": "cuda",
                   "source": src + cu, "replaces": ref + at,
                   "library_ms": None, "per_stage": []}
            for tag, name, cu, at in rows}


K3_NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias", "dln")
K4_NAMES = ("dx", "dln", "dw1", "db1", "dw2", "db2")


def phase_kernels(groups=KERNEL_GROUPS):
    """Every kernel against its plain version at the shapes the main paths
    give it; the list of their reports, in the order K1-K10."""
    rep = _kernel_reports()
    if "swin" in groups:
        _swin_kernels(rep)
    if "zoo" in groups:
        _zoo_kernels(rep)
    if "dw27" in groups:
        _dw27_kernel(rep["dw27"])
    if "dice_ce" in groups:
        _dice_ce_kernels(rep["dice_ce_sums"], rep["dice_ce_dlogits"])
    if "conv" in groups:
        _conv_kernels(rep["winograd_conv3d_f23"], rep["conv3x3x3"])
    if "fp32" in groups:
        _fp32_kernels(rep)
    if "f5" in groups:
        _f5_kernels(rep)
    if "r15" in groups:
        _r15_kernels(rep)
    if "official" in groups:
        _official_kernels(rep["window_attention"])
    if "zoo_rest" in groups:
        _zoo_rest_kernels(rep)
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
                want = kwa.window_attention_plain(wins, **a, **kw)
                for route in kwa.ROUTES:  # heads and projection launches
                    got = kwa.window_attention(wins, **a, **kw, route=route,
                                               gemm_route=route)
                    torch.cuda.synchronize()
                    _compare(f"K1 {route} grid {grid}^3 x{batch}, C={c}, "
                             f"nh={nh}, shift {shift}, ln {ln}, res {res}",
                             got, want, k1)
                del got, want
            _timed(k1, "window_attention", "predict", PREDICT_BATCH, grid, c,
                   nh, lambda: kwa.window_attention(wins, **a, **kw),
                   lambda: kwa.window_attention_plain(wins, **a, **kw), 10,
                   extra={"cuda_core": lambda: kwa.window_attention(
                              wins, **a, **kw, route="cuda_core",
                              gemm_route="cuda_core"),
                          **_sdpa_reference(wins, a, kw)})
            _k1_launches(k1, "predict", wins, a, kw)
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
                want = kwa.window_attention_bwd_plain(wins, dy=dy, **b, **kw)
                for route in kwa.ROUTES:  # heads, dx and dw launches
                    got = kwa.window_attention_bwd(wins, dy=dy, **b, **kw,
                                                   route=route,
                                                   gemm_route=route)
                    torch.cuda.synchronize()
                    _compare_grads(f"K3 {route} " + case, K3_NAMES, got, want,
                                   k3)
                    if route == "tensor_core":  # partials in a fixed order
                        again = kwa.window_attention_bwd(wins, dy=dy, **b,
                                                         **kw)
                        _require(all((u is None and v is None)
                                     or torch.equal(u, v)
                                     for u, v in zip(got, again)),
                                 f"K3 {route} {case}: a rerun differs")
                        del again
                del got, want
            _timed(k1, "window_attention", "train", TRAIN_BATCH, grid, c, nh,
                   lambda: kwa.window_attention(wins, **a, **kw),
                   lambda: kwa.window_attention_plain(wins, **a, **kw), 10,
                   extra={"cuda_core": lambda: kwa.window_attention(
                       wins, **a, **kw, route="cuda_core",
                       gemm_route="cuda_core")})
            _timed(k3, "window_attention_bwd", "train", TRAIN_BATCH, grid, c,
                   nh, lambda: kwa.window_attention_bwd(wins, dy=dy, **b, **kw),
                   lambda: kwa.window_attention_bwd_plain(wins, dy=dy, **b,
                                                          **kw), 5,
                   extra={"cuda_core": lambda: kwa.window_attention_bwd(
                              wins, dy=dy, **b, **kw, route="cuda_core",
                              gemm_route="cuda_core"),
                          **_sdpa_reference(wins, a, kw, grad=True)})
            _k3_launches(k3, wins, b, kw, dy)
            del wins, a, b, kw, dy
            torch.cuda.empty_cache()

            # ---- MLP, both routes
            for batch, ln_res in ((2, False), (PREDICT_BATCH, True)):
                x, a, kw = _mlp_case(gen, batch, grid, c, ln_res, ln_res)
                want = kmlp.fused_mlp_plain(x, **a, **kw)
                for route in kmlp.ROUTES:
                    got = kmlp.fused_mlp(x, **a, **kw, route=route)
                    torch.cuda.synchronize()
                    _compare(f"K2 {route} grid {grid}^3 x{batch}, C={c}, "
                             f"ln+res {ln_res}", got, want, k2)
                del got, want
            _timed(k2, "fused_mlp", "predict", PREDICT_BATCH, grid, c, nh,
                   lambda: kmlp.fused_mlp(x, **a, **kw),
                   lambda: kmlp.fused_mlp_plain(x, **a, **kw), 10,
                   extra={"cuda_core": lambda: kmlp.fused_mlp(
                              x, **a, **kw, route="cuda_core"),
                          **_mlp_reference(x, a, kw)})
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
                    want = kmlp.fused_mlp_plain(x, **a, **kw)
                    for route in kmlp.ROUTES:
                        got = kmlp.fused_mlp(x, **a, **kw, route=route)
                        torch.cuda.synchronize()
                        _compare(f"K2 {route} " + case, got, want, k2)
                dy = torch.randn(x.shape, generator=gen,
                                 device="cuda").to(x.dtype)
                b = dict(w1=a["w1"], b1=a["b1"], w2=a["w2"], ln=kw["ln"],
                         dy=dy, residual=res)
                want = kmlp.fused_mlp_bwd_plain(x, **b)
                for route in kmlp.ROUTES:
                    got = kmlp.fused_mlp_bwd(x, **b, route=route)
                    torch.cuda.synchronize()
                    _compare_grads(f"K4 {route} " + case, K4_NAMES, got, want,
                                   k4)
                    if route == "tensor_core":  # partials in a fixed order
                        again = kmlp.fused_mlp_bwd(x, **b, route=route)
                        _require(all(torch.equal(u, v)
                                     for u, v in zip(got, again)),
                                 f"K4 {route} {case}: a rerun differs")
                        del again
                del got, want
            _timed(k2, "fused_mlp", "train", TRAIN_BATCH, grid, c, nh,
                   lambda: kmlp.fused_mlp(x, **a, **kw),
                   lambda: kmlp.fused_mlp_plain(x, **a, **kw), 10,
                   extra={"cuda_core": lambda: kmlp.fused_mlp(
                              x, **a, **kw, route="cuda_core"),
                          **_mlp_reference(x, a, kw)})
            _timed(k4, "fused_mlp_bwd", "train", TRAIN_BATCH, grid, c, nh,
                   lambda: kmlp.fused_mlp_bwd(x, **b),
                   lambda: kmlp.fused_mlp_bwd_plain(x, **b), 5,
                   extra={"cuda_core": lambda: kmlp.fused_mlp_bwd(
                              x, **b, route="cuda_core"),
                          **_mlp_reference(x, a, kw, grad=True)})
            del x, a, b, kw, dy
            torch.cuda.empty_cache()
    # one launch at each of the four stages: the forward kernels at the
    # predictor call's shape (as measured since the first slice), the
    # backward kernels at the training step's
    for k, path in ((k1, "predict"), (k2, "predict"), (k3, "train"),
                    (k4, "train")):
        _sum_stages(k, path)


GCVIT_MLP_RATIO = 3   # GC-ViT's token MLP: hidden 3C
# SegFormer3D stages at roi 96: (tokens N, C, heads); M = 27 reduced tokens
SR_STAGES = ((24 ** 3, 48, 3), (12 ** 3, 96, 6), (6 ** 3, 192, 12),
             (3 ** 3, 384, 24))
SR_M = 27


def _rel_bias(gen, nh, quirk):
    """(nh, N, N) fp32 bias gathered from a seeded table with the standard
    index, or with the reference's colliding-stride one (the pre_bias the
    GC-ViT module gathers under --ref_quirk_rel_pos)."""
    import torch

    from medicalsemseg_tpu_torch.ops import window as tw

    table = torch.randn((2 * WS - 1) ** 3, nh, generator=gen, device="cuda")
    index = (tw.relative_position_index_ref_quirk if quirk
             else tw.relative_position_index)((WS,) * 3)
    idx = torch.from_numpy(index.reshape(-1).astype("int64")).to("cuda")
    return tw.gather_rel_bias(table, idx, WS ** 3)


def _global_case(gen, batch, grid, c, nh, absorbed, quirk, dtype=None):
    """K6's arguments: the absorbed form (LN and shortcut in the kernel, kv
    bias) or the bare form (neither, and no kv bias)."""
    import torch

    from medicalsemseg_tpu_torch.ops import window as tw

    dev, bf = "cuda", dtype or torch.bfloat16
    n = WS ** 3
    x = torch.randn(batch, grid, grid, grid, c, generator=gen,
                    device=dev).to(bf)
    wins = tw.window_partition(x, WS).contiguous()
    s = c ** -0.5
    args = dict(
        q_global=torch.randn(batch, n, c, generator=gen, device=dev).to(bf),
        wkv=(torch.randn(2 * c, c, generator=gen, device=dev) * s).to(bf),
        bkv=(torch.randn(2 * c, generator=gen, device=dev) * 0.1
             if absorbed else None),
        wproj=(torch.randn(c, c, generator=gen, device=dev) * s).to(bf),
        bproj=torch.randn(c, generator=gen, device=dev) * 0.1,
        bias=_rel_bias(gen, nh, quirk))
    kw = dict(residual=absorbed,
              ln=(torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                               0.1 * torch.randn(c, generator=gen, device=dev)])
                  if absorbed else None))
    return wins, args, kw


def _sr_case(gen, batch, n, c, nh, res, bq, dtype=None):
    import torch

    dev, bf = "cuda", dtype or torch.bfloat16
    s = c ** -0.5

    def act(rows):
        return torch.randn(batch, rows, c, generator=gen, device=dev).to(bf)

    x = act(n)
    args = dict(
        k=act(SR_M), v=act(SR_M),
        wq=(torch.randn(c, c, generator=gen, device=dev) * s).to(bf),
        bq=torch.randn(c, generator=gen, device=dev) * 0.1 if bq else None,
        wproj=(torch.randn(c, c, generator=gen, device=dev) * s).to(bf),
        bproj=torch.randn(c, generator=gen, device=dev) * 0.1,
        num_heads=nh, residual=act(n) if res else None)
    return x, args


def _sr_reference(x, a):
    """K7's products by the library in the compute dtype: F.linear ->
    scaled_dot_product_attention -> F.linear (+ the shortcut). A reference
    point, not K7's function (SDPA scales q before the dot and rounds
    elsewhere), so not its library_ms."""
    import torch
    import torch.nn.functional as F

    b, n, c = x.shape
    nh, dt = a["num_heads"], x.dtype
    bq = None if a["bq"] is None else a["bq"].to(dt)
    bproj, res = a["bproj"].to(dt), a["residual"]

    def heads(t):
        return t.reshape(b, -1, nh, c // nh).transpose(1, 2)

    def fn():
        o = F.scaled_dot_product_attention(heads(F.linear(x, a["wq"], bq)),
                                           heads(a["k"]), heads(a["v"]))
        y = F.linear(o.transpose(1, 2).reshape(b, n, c), a["wproj"], bproj)
        return y if res is None else y + res

    with torch.inference_mode():
        fn()
    return fn


def _stage_report(report, label, c, batch, ms, pms, flops, nbytes,
                  peak=None, extra=None):
    bound, by = _bound(flops, nbytes, peak or PEAK_BF16_FLOPS)
    stage = {"C": c, "batch": batch, "path": label, "ms": ms, "plain_ms": pms,
             "flops": flops, "bytes": nbytes, "bound_ms": bound,
             "bound_by": by}
    more = _extra_times(stage, extra, 10)
    report["per_stage"].append(stage)
    print(f"  {report['tag']} {label} x{batch}, C={c}: kernel {ms:.3f} ms, "
          f"plain {pms:.3f} ms{more}, bound {bound:.4f} ms by {by} "
          f"({flops:.3e} FLOP, {nbytes:.3e} B)", flush=True)


def _sum_stages(report, path):
    """One launch at each of the four stages of ``path``."""
    stages = [s for s in report["per_stage"] if s["path"] == path]
    for key in ("ms", "plain_ms", "bound_ms"):
        report[key] = sum(s[key] for s in stages)
    ops = sum(s["flops"] for s in stages) / PEAK_BF16_FLOPS
    mem = sum(s["bytes"] for s in stages) / PEAK_HBM_BYTES
    report["bound_by"] = "operations" if ops >= mem else "bytes"


def _zoo_kernels(rep):
    """K6 at the four GC-ViT stages and K7 at the four SegFormer3D stages, at
    the shapes of one predictor call (16 windows of 96^3), and K2 at GC-ViT's
    hidden width 3C, each against its plain version."""
    import torch

    from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr

    gen = torch.Generator(device="cuda").manual_seed(6)
    k2, k6, k7 = (rep["fused_mlp"], rep["global_window_attention"],
                  rep["sr_attention"])
    n = WS ** 3
    with torch.inference_mode():
        for grid, c, nh in STAGES:
            # batch 2 with its own queries per element, then the predictor
            # call's batch; the absorbed form with the standard bias comes
            # last and is the one timed
            for batch, absorbed, quirk in ((2, True, False),
                                           (PREDICT_BATCH, False, False),
                                           (PREDICT_BATCH, False, True),
                                           (PREDICT_BATCH, True, True),
                                           (PREDICT_BATCH, True, False)):
                wins, a, kw = _global_case(gen, batch, grid, c, nh, absorbed,
                                           quirk)
                want = kga.global_window_attention_plain(wins, **a, **kw)
                for route in ("tensor_core", "cuda_core"):
                    got = kga.global_window_attention(wins, **a, **kw,
                                                      route=route,
                                                      gemm_route=route)
                    torch.cuda.synchronize()
                    _compare(f"K6 {route} grid {grid}^3 x{batch}, C={c}, "
                             f"nh={nh}, ln+res+bkv {absorbed}, "
                             f"{'quirk' if quirk else 'standard'} bias", got,
                             want, k6)
                del got, want
            t = wins.shape[0]
            m = t * n
            _stage_report(
                k6, "predict", c, PREDICT_BATCH,
                _time_ms(lambda: kga.global_window_attention(wins, **a, **kw),
                         10),
                _time_ms(lambda: kga.global_window_attention_plain(
                    wins, **a, **kw), 10),
                # kv and proj; q k^T and p v per head
                6 * m * c * c + 4 * t * n * n * c,
                # windows in and out, queries, weights, biases, LN, bias
                2 * m * c * 2 + PREDICT_BATCH * n * c * 2 + 3 * c * c * 2
                + 5 * c * 4 + nh * n * n * 4,
                extra={"cuda_core": lambda: kga.global_window_attention(
                    wins, **a, **kw, route="cuda_core",
                    gemm_route="cuda_core")})
            _k1_launches(k6, "predict", wins, a, kw,
                         call=lambda **r: kga.global_window_attention(
                             wins, **a, **kw, **r))
            del wins, a, kw
            torch.cuda.empty_cache()

            x, a, kw = _mlp_case(gen, PREDICT_BATCH, grid, c, True, True,
                                 GCVIT_MLP_RATIO)
            want = kmlp.fused_mlp_plain(x, **a, **kw)
            for route in kmlp.ROUTES:
                got = kmlp.fused_mlp(x, **a, **kw, route=route)
                torch.cuda.synchronize()
                _compare(f"K2 {route} grid {grid}^3 x{PREDICT_BATCH}, C={c}, "
                         f"hidden {GCVIT_MLP_RATIO * c}, ln+res True", got,
                         want, k2)
            del got, want
            m = x.shape[0]
            _stage_report(
                k2, "predict_3c", c, PREDICT_BATCH,
                _time_ms(lambda: kmlp.fused_mlp(x, **a, **kw), 10),
                _time_ms(lambda: kmlp.fused_mlp_plain(x, **a, **kw), 10),
                4 * GCVIT_MLP_RATIO * m * c * c,
                2 * m * c * 2 + 2 * GCVIT_MLP_RATIO * c * c * 2
                + (GCVIT_MLP_RATIO + 1) * c * 4 + 2 * c * 4,
                extra={"cuda_core": lambda: kmlp.fused_mlp(
                           x, **a, **kw, route="cuda_core"),
                       **_mlp_reference(x, a, kw)})
            del x, a, kw
            torch.cuda.empty_cache()

        for ntok, c, nh in SR_STAGES:
            # the last stage's 27 tokens are one ragged tile; with the
            # shortcut and the q bias comes last and is the one timed; both
            # routes against plain, and the tensor cores' head-split form
            # (stages 3 and 4) rerun bit-equal
            for res, bq in ((False, False), (False, True), (True, True)):
                x, a = _sr_case(gen, PREDICT_BATCH, ntok, c, nh, res, bq)
                want = ksr.sr_attention_plain(x, **a)
                for route in ksr.ROUTES:
                    got = ksr.sr_attention(x, **a, route=route)
                    torch.cuda.synchronize()
                    _compare(f"K7 {route} {PREDICT_BATCH}x{ntok} tokens, "
                             f"M={SR_M}, C={c}, nh={nh}, residual {res}, bq "
                             f"{bq}", got, want, k7)
                    if route == "tensor_core":
                        _require(torch.equal(got, ksr.sr_attention(
                            x, **a, route=route)), f"K7 tensor_core C={c}: "
                            "a second run is not bit-equal")
                del got, want
            rows = PREDICT_BATCH * ntok
            plan = ksr.sr_plan(PREDICT_BATCH, ntok, c, nh, SR_M,
                               torch.cuda.get_device_properties(0)
                               .multi_processor_count)
            print(f"  K7 C={c}: tensor-core plan (rows, groups, slots) "
                  f"{plan}", flush=True)
            _stage_report(
                k7, "predict", c, PREDICT_BATCH,
                _time_ms(lambda: ksr.sr_attention(x, **a), 10),
                _time_ms(lambda: ksr.sr_attention_plain(x, **a), 10),
                # q and proj; q k^T and p v
                4 * rows * c * c + 4 * rows * SR_M * c,
                # x, shortcut, out; k, v; weights; biases
                3 * rows * c * 2 + 2 * PREDICT_BATCH * SR_M * c * 2
                + 2 * c * c * 2 + 2 * c * 4,
                extra={"cuda_core": lambda: ksr.sr_attention(
                           x, **a, route="cuda_core"),
                       "reference": _sr_reference(x, a)})
            # the kernels' own device time (the CUDA events above time
            # back-to-back calls, which the host's cost per call can bound)
            stage = k7["per_stage"][-1]
            for route in ksr.ROUTES:
                stage[f"{route}_device_ms"] = _launch_times(
                    lambda: ksr.sr_attention(x, **a, route=route), 10,
                    (("k7", "sr_attention"),))["k7"]
            print(f"  K7 predict x{PREDICT_BATCH}, C={c}: device time "
                  f"tensor_core {stage['tensor_core_device_ms']:.4f} ms, "
                  f"cuda_core {stage['cuda_core_device_ms']:.4f} ms",
                  flush=True)
            del x, a
            torch.cuda.empty_cache()
    _sum_stages(k6, "predict")
    _sum_stages(k7, "predict")


# K1-K4, K6, K7 in fp32 against their plain versions in fp32: no rounding to
# flip, only fp32 sums in another order (outputs O(1): a few 1e-7 each, more
# after the softmax's exp); weight gradients sum up to 884,736 terms, so the
# same norm-and-largest-element rule as in bf16, far tighter
FP32_KERNEL_TOL = 1e-4
FP32_GRAD_NORM_TOL = 1e-5
FP32_GRAD_MAX_TOL = 1e-4


def _fp32_kernels(rep):
    """K1-K4, K6 and K7 in fp32 (``--compute_dtype float32``) at the four
    stages of their main paths: against their plain versions, and timed
    beside a bound with fp32's rate (the products run on CUDA cores in
    either dtype) and 4-byte activations and weights."""
    import torch

    from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    gen = torch.Generator(device="cuda").manual_seed(32)
    f32, n = torch.float32, WS ** 3
    k1, k2 = rep["window_attention"], rep["fused_mlp"]
    k3, k4 = rep["window_attention_bwd"], rep["fused_mlp_bwd"]
    k6, k7 = rep["global_window_attention"], rep["sr_attention"]
    timed = dict(iters=5, elem=4, peak=PEAK_FP32_FLOPS)
    with torch.inference_mode():
        for grid, c, nh in STAGES:
            wins, a, kw = _attn_case(gen, PREDICT_BATCH, grid, c, nh, WS // 2,
                                     True, True, f32)
            _compare(f"K1 fp32 grid {grid}^3 x{PREDICT_BATCH}, C={c}",
                     kwa.window_attention(wins, **a, **kw),
                     kwa.window_attention_plain(wins, **a, **kw), k1,
                     FP32_KERNEL_TOL)
            _timed(k1, "window_attention", "predict_fp32", PREDICT_BATCH, grid,
                   c, nh, lambda: kwa.window_attention(wins, **a, **kw),
                   lambda: kwa.window_attention_plain(wins, **a, **kw),
                   **timed)
            del wins, a, kw
            wins, a, kw = _attn_case(gen, TRAIN_BATCH, grid, c, nh, WS // 2,
                                     True, False, f32)
            dy = torch.randn(wins.shape, generator=gen, device="cuda")
            b = {k: v for k, v in a.items() if k != "bproj"}
            _compare_grads(f"K3 fp32 grid {grid}^3 x{TRAIN_BATCH}, C={c}",
                           K3_NAMES,
                           kwa.window_attention_bwd(wins, dy=dy, **b, **kw),
                           kwa.window_attention_bwd_plain(wins, dy=dy, **b,
                                                          **kw),
                           k3, FP32_GRAD_NORM_TOL, FP32_GRAD_MAX_TOL)
            _timed(k3, "window_attention_bwd", "train_fp32", TRAIN_BATCH, grid,
                   c, nh, lambda: kwa.window_attention_bwd(wins, dy=dy, **b,
                                                           **kw),
                   lambda: kwa.window_attention_bwd_plain(wins, dy=dy, **b,
                                                          **kw), **timed)
            del wins, a, b, kw, dy
            torch.cuda.empty_cache()

            x, a, kw = _mlp_case(gen, PREDICT_BATCH, grid, c, True, True,
                                 dtype=f32)
            _compare(f"K2 fp32 grid {grid}^3 x{PREDICT_BATCH}, C={c}",
                     kmlp.fused_mlp(x, **a, **kw),
                     kmlp.fused_mlp_plain(x, **a, **kw), k2, FP32_KERNEL_TOL)
            _timed(k2, "fused_mlp", "predict_fp32", PREDICT_BATCH, grid, c, nh,
                   lambda: kmlp.fused_mlp(x, **a, **kw),
                   lambda: kmlp.fused_mlp_plain(x, **a, **kw), **timed)
            del x, a, kw
            x, a, kw = _mlp_case(gen, TRAIN_BATCH, grid, c, True, False,
                                 dtype=f32)
            b = dict(w1=a["w1"], b1=a["b1"], w2=a["w2"], ln=kw["ln"],
                     dy=torch.randn(x.shape, generator=gen, device="cuda"),
                     residual=False)
            _compare_grads(f"K4 fp32 grid {grid}^3 x{TRAIN_BATCH}, C={c}",
                           K4_NAMES, kmlp.fused_mlp_bwd(x, **b),
                           kmlp.fused_mlp_bwd_plain(x, **b), k4,
                           FP32_GRAD_NORM_TOL, FP32_GRAD_MAX_TOL)
            _timed(k4, "fused_mlp_bwd", "train_fp32", TRAIN_BATCH, grid, c, nh,
                   lambda: kmlp.fused_mlp_bwd(x, **b),
                   lambda: kmlp.fused_mlp_bwd_plain(x, **b), **timed)
            del x, a, b, kw
            torch.cuda.empty_cache()

            wins, a, kw = _global_case(gen, PREDICT_BATCH, grid, c, nh, True,
                                       False, f32)
            _compare(f"K6 fp32 grid {grid}^3 x{PREDICT_BATCH}, C={c}",
                     kga.global_window_attention(wins, **a, **kw),
                     kga.global_window_attention_plain(wins, **a, **kw), k6,
                     FP32_KERNEL_TOL)
            t = wins.shape[0]
            m = t * n
            _stage_report(
                k6, "predict_fp32", c, PREDICT_BATCH,
                _time_ms(lambda: kga.global_window_attention(wins, **a, **kw),
                         5),
                _time_ms(lambda: kga.global_window_attention_plain(
                    wins, **a, **kw), 5),
                6 * m * c * c + 4 * t * n * n * c,
                2 * m * c * 4 + PREDICT_BATCH * n * c * 4 + 3 * c * c * 4
                + 5 * c * 4 + nh * n * n * 4, PEAK_FP32_FLOPS)
            del wins, a, kw
            torch.cuda.empty_cache()

        for ntok, c, nh in SR_STAGES:
            x, a = _sr_case(gen, PREDICT_BATCH, ntok, c, nh, True, True, f32)
            _compare(f"K7 fp32 {PREDICT_BATCH}x{ntok} tokens, C={c}",
                     ksr.sr_attention(x, **a), ksr.sr_attention_plain(x, **a),
                     k7, FP32_KERNEL_TOL)
            rows = PREDICT_BATCH * ntok
            _stage_report(
                k7, "predict_fp32", c, PREDICT_BATCH,
                _time_ms(lambda: ksr.sr_attention(x, **a), 5),
                _time_ms(lambda: ksr.sr_attention_plain(x, **a), 5),
                4 * rows * c * c + 4 * rows * SR_M * c,
                3 * rows * c * 4 + 2 * PREDICT_BATCH * SR_M * c * 4
                + 2 * c * c * 4 + 2 * c * 4, PEAK_FP32_FLOPS)
            del x, a
            torch.cuda.empty_cache()


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


# K9's launches of one flagship predictor call (16 windows of 96^3) under
# MEDSEG_FUSED_DECODER=1: (volume edge, C = Co, launches): conv2 of
# unet_encoders[0] and unet_decoders[0] at 96^3, of [1] at 48^3, of [2] at
# 24^3 (the fused phase derives the count from the gate; this table only
# picks the shapes to measure)
WINO_PREDICT = ((96, 48, 2), (48, 48, 2), (24, 96, 2))
# the full-resolution convs of one training step at batch 8 under
# MEDSEG_WINOGRAD_TRAIN=1: (C, Co) of the forward and of dx (dy's channels in)
WINO_TRAIN = ((48, 48), (96, 48))
IM2COL_BATCHES = (1, 4)
# K10 against its plain version in fp16 (an ulp is 2^-10 relative: a
# flipped rounding) and fp32 (no rounding to flip, only the order of sums)
F16_KERNEL_TOL = 4e-3
F32_KERNEL_TOL = 1e-4
# K9 against its plain version by dtype: in bf16 and fp16 both round V at the
# same points and y once, so they differ where a differently ordered fp32 sum
# flips a rounding; in fp32 only the order of the sums differs
K9_DTYPE_TOL = {"bfloat16": KERNEL_ATOL, "float16": F16_KERNEL_TOL,
                "float32": F32_KERNEL_TOL}


def _time_once_ms(fn):
    """One timed run, for the plain versions of the conv kernels, which take
    seconds at the main path's shapes (the comparison before it was the
    warm-up)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _conv_work(batch, edge, c, co, epilogue=False, elem=2):
    """Of one 3^3 conv over batch x edge^3 voxels: the 27-tap FLOPs, the
    FLOPs of the 64 Winograd products per 2^3 tile, and the bytes (x read
    once, y written once, of ``elem`` bytes; the weights once; the
    epilogue's fp32 scale and shift)."""
    m = batch * edge ** 3
    tiles = batch * (-(-edge // 2)) ** 3
    nbytes = m * (c + co) * elem + 27 * c * co * elem
    if epilogue:
        nbytes += batch * 2 * c * 4
    return 2 * 27 * m * c * co, 2 * 64 * tiles * c * co, nbytes


def _lib_conv(x, w):
    """The library's conv on the channels-last view: the yardstick."""
    import torch.nn.functional as F

    return F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1)


def _conv_kernels(k9r, k10r):
    """K9 and K10 against their plain versions, and timed beside the
    library's conv, at the shapes the main paths give them."""
    import torch
    import torch.nn.functional as F

    from medicalsemseg_tpu_torch.ops.kernels import conv3d as k10
    from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

    gen = torch.Generator(device="cuda").manual_seed(9)
    bf = torch.bfloat16

    def case(batch, dims, c, co, dt=bf):
        x = torch.randn(batch, *dims, c, generator=gen, device="cuda").to(dt)
        w = (torch.randn(co, c, 3, 3, 3, generator=gen, device="cuda")
             * (27 * c) ** -0.5).to(dt)
        return x, w

    def epilogue(batch, c):
        # as a folded InstanceNorm gives them, distinct per sample; the shift
        # is well off 0, so a halo that was activated and not set back to 0
        # would show at every border voxel
        return (1 + 0.3 * torch.randn(batch, c, generator=gen, device="cuda"),
                1 + torch.randn(batch, c, generator=gen, device="cuda"))

    def check(tag, rep, name, fn, plain, tol=KERNEL_ATOL):
        got = fn()
        torch.cuda.synchronize()
        _compare(f"{tag} {name}", got, plain(), rep, tol)
        _require(torch.equal(got, fn()),
                 f"{tag} {name}: a second run is not bit-equal")

    with torch.inference_mode():
        # small and odd first: masked tails, ragged channel tiles
        for dims, c, co in (((5, 7, 9), 16, 24), ((6, 10, 35), 40, 56)):
            x, w = case(2, dims, c, co)
            ep = epilogue(2, c)
            name = f"2x{'x'.join(map(str, dims))}, {c}->{co}"
            check("K9", k9r, name + " bare",
                  lambda: k9.winograd_conv3d_f23(x, w),
                  lambda: k9.winograd_conv3d_f23_plain(x, w))
            check("K9", k9r, name + " epilogue + lrelu",
                  lambda: k9.winograd_conv3d_f23(x, w, epilogue=ep, lrelu=True),
                  lambda: k9.winograd_conv3d_f23_plain(x, w, epilogue=ep,
                                                       lrelu=True))
            check("K10", k10r, name, lambda: k10.conv3x3x3_fwd(x, w),
                  lambda: k10.conv3x3x3_plain(x, w))
        # K10 at the edges of its widths: 8 and 128 output channels (a
        # tensor-core block of 16 and one of 128), 8 input channels (one k
        # step of 16, half of it zero)
        for dims, c, co in (((5, 7, 9), 16, 8), ((5, 7, 9), 8, 24),
                            ((6, 10, 35), 40, 128), ((6, 10, 35), 8, 128)):
            x, w = case(2, dims, c, co)
            check("K10", k10r, f"2x{'x'.join(map(str, dims))}, {c}->{co}",
                  lambda: k10.conv3x3x3_fwd(x, w),
                  lambda: k10.conv3x3x3_plain(x, w))

        def k9_stage(path, batch, edge, c, co, with_ep, dt=bf):
            x, w = case(batch, (edge,) * 3, c, co, dt)
            kw = (dict(epilogue=epilogue(batch, c), lrelu=True) if with_ep
                  else {})
            form = "epilogue + lrelu" if with_ep else "bare"
            dname = str(dt).split(".")[-1]
            route = k9.winograd_route(dt)
            name = f"{path} {batch}x{edge}^3, {c}->{co}, {form}"
            if dt != bf:
                name += f", {dname}"
            before = k9.route_launches[route]
            check("K9", k9r, name,
                  lambda: k9.winograd_conv3d_f23(x, w, **kw),
                  lambda: k9.winograd_conv3d_f23_plain(x, w, **kw),
                  K9_DTYPE_TOL[dname])
            _require(k9.route_launches[route] == before + 2,
                     f"K9 {name}: not on the {route} route")
            ms = _time_ms(lambda: k9.winograd_conv3d_f23(x, w, **kw), 5)
            pms = _time_once_ms(
                lambda: k9.winograd_conv3d_f23_plain(x, w, **kw))
            if with_ep:
                # no single call computes it; the chain the unfused model
                # runs after the statistics, as a note
                sc, sh = (t[:, None, None, None, :] for t in kw["epilogue"])
                lms = None
                chain = _time_ms(lambda: _lib_conv(F.leaky_relu(
                    (x.float() * sc + sh).to(dt), 0.01), w), 5)
            else:
                lms = _time_ms(lambda: _lib_conv(x, w), 5)
                chain = None
            direct, wino, nbytes = _conv_work(batch, edge, c, co, with_ep,
                                              elem=x.element_size())
            bound, by = _bound(wino, nbytes, PEAK_FP32_FLOPS if dt ==
                               torch.float32 else PEAK_BF16_FLOPS)
            k9r["per_stage"].append({
                "path": path, "batch": batch, "edge": edge, "C": c, "Co": co,
                "epilogue": with_ep, "dtype": dname, "route": route,
                "ms": ms, "plain_ms": pms,
                "library_ms": lms, "chain_ms": chain, "flops": wino,
                "direct_flops": direct, "bytes": nbytes, "bound_ms": bound,
                "bound_by": by})
            lib = (f"normalize -> leaky_relu -> F.conv3d {chain:.3f} ms"
                   if with_ep else f"F.conv3d {lms:.3f} ms")
            print(f"  K9 {name}: kernel {ms:.3f} ms, plain {pms:.1f} ms, "
                  f"{lib}, bound {bound:.4f} ms by {by} ({wino:.3e} Winograd "
                  f"FLOP, {direct:.3e} direct FLOP, {nbytes:.3e} B)",
                  flush=True)
            del x, w, kw
            torch.cuda.empty_cache()

        for edge, c, _ in WINO_PREDICT:
            for with_ep in (False, True):
                k9_stage("predict", PREDICT_BATCH, edge, c, c, with_ep)
        # the fp16 and fp32 forms at the predictor call's shapes: fp16 on
        # the tensor cores (bound at the bf16 rate), fp32 on the CUDA cores
        # (bound at the fp32 rate, the library's conv without TF32)
        with _no_tf32():
            for dt in (torch.float16, torch.float32):
                for edge, c, _ in WINO_PREDICT:
                    for with_ep in (False, True):
                        k9_stage("predict", PREDICT_BATCH, edge, c, c,
                                 with_ep, dt)
        for c, co in WINO_TRAIN:
            k9_stage("train fwd", TRAIN_BATCH, CROP, c, co, False)
            if c != co:
                k9_stage("train dx", TRAIN_BATCH, CROP, co, c, False)

        for batch in IM2COL_BATCHES:
            for c, co in DW27_CONVS:
                for what, ci, cj in (("fwd", c, co), ("dx", co, c)):
                    if what == "dx" and c == co:
                        continue        # the forward's shape again
                    x, w = case(batch, (CROP,) * 3, ci, cj)
                    name = f"{what} {batch}x{CROP}^3, {ci}->{cj}"
                    check("K10", k10r, name, lambda: k10.conv3x3x3_fwd(x, w),
                          lambda: k10.conv3x3x3_plain(x, w))
                    ms = _time_ms(lambda: k10.conv3x3x3_fwd(x, w), 5)
                    pms = _time_once_ms(lambda: k10.conv3x3x3_plain(x, w))
                    lms = _time_ms(lambda: _lib_conv(x, w), 5)
                    flops, _, nbytes = _conv_work(batch, CROP, ci, cj)
                    bound, by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
                    k10r["per_stage"].append({
                        "path": what, "batch": batch, "C": ci, "Co": cj,
                        "dtype": "bfloat16", "route": "tensor_core",
                        "ms": ms, "plain_ms": pms, "library_ms": lms,
                        "flops": flops, "bytes": nbytes, "bound_ms": bound,
                        "bound_by": by})
                    print(f"  K10 {name}: kernel {ms:.3f} ms, plain {pms:.1f} "
                          f"ms, F.conv3d {lms:.3f} ms, bound {bound:.4f} ms "
                          f"by {by} ({flops:.3e} FLOP, {nbytes:.3e} B)",
                          flush=True)
                    del x, w
                    torch.cuda.empty_cache()

        # the fp16 and fp32 forms at one batch-1 shape: fp16 on the tensor
        # cores (bound at the bf16 rate), fp32 on the CUDA cores (bound at
        # the fp32 rate, the library's conv without TF32)
        for dt, route, peak, tol in (
                (torch.float16, "tensor_core", PEAK_BF16_FLOPS, F16_KERNEL_TOL),
                (torch.float32, "cuda_core", PEAK_FP32_FLOPS, F32_KERNEL_TOL)):
            ci = cj = 48
            x, w = case(1, (CROP,) * 3, ci, cj, dt)
            dname = str(dt).split(".")[-1]
            name = f"fwd 1x{CROP}^3, {ci}->{cj}, {dname}"
            before = k10.route_launches[route]
            check("K10", k10r, name, lambda: k10.conv3x3x3_fwd(x, w),
                  lambda: k10.conv3x3x3_plain(x, w), tol)
            _require(k10.route_launches[route] == before + 2,
                     f"K10 {name}: not on the {route} route")
            ms = _time_ms(lambda: k10.conv3x3x3_fwd(x, w), 5)
            pms = _time_once_ms(lambda: k10.conv3x3x3_plain(x, w))
            with _no_tf32():
                lms = _time_ms(lambda: _lib_conv(x, w), 5)
            flops, _, nbytes = _conv_work(1, CROP, ci, cj,
                                          elem=x.element_size())
            bound, by = _bound(flops, nbytes, peak)
            k10r["per_stage"].append({
                "path": "fwd", "batch": 1, "C": ci, "Co": cj, "dtype": dname,
                "route": route, "ms": ms, "plain_ms": pms, "library_ms": lms,
                "flops": flops, "bytes": nbytes, "bound_ms": bound,
                "bound_by": by})
            print(f"  K10 {name}: kernel {ms:.3f} ms, plain {pms:.1f} ms, "
                  f"F.conv3d {lms:.3f} ms, bound {bound:.4f} ms by {by} "
                  f"({flops:.3e} FLOP, {nbytes:.3e} B)", flush=True)
            del x, w
            torch.cuda.empty_cache()

    # K9: the six launches of one predictor call with the fused decoder
    stages = {(s["edge"], s["C"]): s for s in k9r["per_stage"]
              if s["path"] == "predict" and s["epilogue"]
              and s["dtype"] == "bfloat16"}
    for key in ("ms", "plain_ms", "chain_ms", "bound_ms"):
        k9r[key] = sum(n * stages[(edge, c)][key]
                       for edge, c, n in WINO_PREDICT)
    k9r["bound_by"] = stages[WINO_PREDICT[0][:2]]["bound_by"]
    # K10: one call of the function at batch 4, 48 -> 48: forward and dx
    # (the same shape); its dW is K5's launch, in K5's row
    main = next(s for s in k10r["per_stage"]
                if s["batch"] == TRAIN_B4_BATCH and s["dtype"] == "bfloat16"
                and (s["C"], s["Co"]) == (48, 48))
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        k10r[key] = 2 * main[key]
    k10r["bound_by"] = main["bound_by"]


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
        # labels outside [0, C) (-2 .. C + 1) at the ragged shape: no one-hot
        # row and no CE term, p^2 left out where the label is negative, as
        # the JAX kernels do (fault F4)
        for b, m, lo, hi in ((3, 100003, 0, c), (3, 100003, -2, c + 2),
                             (8, CROP ** 3, 0, c),
                             (TRAIN_B4_BATCH, CROP ** 3, 0, c)):
            logits = torch.randn(b, m, c, generator=gen, device="cuda") * 2.0
            labels = torch.randint(lo, hi, (b, m), generator=gen,
                                   device="cuda")
            name = f"{b}x{m}x{c}" + (f" labels {lo}..{hi - 1}" if lo else "")
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
                dev = _launch_times(fn, 10, (("partials", "sum_partials"),
                                             ("kernel", "dice_ce")))
                bound, by = _bound(flops, nbytes, PEAK_FP32_FLOPS)
                rep["per_stage"].append({
                    "batch": b, "ms": ms, "plain_ms": pms, "flops": flops,
                    "bytes": nbytes, "bound_ms": bound, "bound_by": by,
                    "device_ms": dev})
                print(f"  K8 {rep['name']} {name}: kernel {ms:.3f} ms "
                      f"(device: {dev}), plain {pms:.3f} ms, bound "
                      f"{bound:.4f} ms by {by} ({flops:.3e} FLOP, "
                      f"{nbytes:.3e} B)", flush=True)
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

    cfg = get_args(FLAGSHIP_ARGS)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = _seeded_model(cfg, gen)
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
        _reset_launches()
        got = gpu(x_gpu)
        torch.cuda.synchronize()
        _check_routes("model", "tensor_core")
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


ZOO_MODELS = ("GCViTUNETR", "SegFormer3D", "SwinSegFormer")
# kernel launches of one predictor call: GC-ViT has a local (K1) and a
# global (K6) block at each of 4 levels and the MLP (K2) in all 8; SegFormer3D
# has 8 blocks (K7); SwinSegFormer has the flagship's encoder
ZOO_LAUNCHES = {
    "GCViTUNETR": {"window_attention": 4, "global_window_attention": 4,
                   "fused_mlp": 8},
    "SegFormer3D": {"sr_attention": 8},
    "SwinSegFormer": {"window_attention": 8, "fused_mlp": 8},
}


def _zoo_args(name):
    return ["--model", name] + FLAGSHIP_ARGS[2:] + [
        "--depths", "2", "2", "2", "2", "--num_heads", "3", "6", "12", "24"]


def _seeded_model(cfg, gen):
    """The model with the JAX initialisers, then widened: dense std 0.02
    leaves attention and MLP outputs near zero, so the dense weights get
    variance 1 / fan_in, bias tables and encoder biases a spread, and the
    BatchNorm running statistics values away from 0 and 1: every kernel and
    every statistic then matters to the logits."""
    import torch

    from medicalsemseg_tpu_torch.models.factory import build_model, init_weights

    model = init_weights(build_model(cfg), gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("qkv.weight", "proj.weight", "fc1.weight",
                              "fc2.weight", ".q.weight", ".kv.weight",
                              ".fc.weight", "gt_upsample.weight",
                              "rel_crop_pos_emb.weight",
                              # FocalNet's modulation, LRGFormer's streams
                              # and global downsampling, Swin2D's merging
                              # and head
                              "modulation.f.weight", "modulation.h.weight",
                              "qkv_local.weight", "qkv_region.weight",
                              "qkv_global.weight", "proj_local.weight",
                              "proj_region.weight", "proj_global.weight",
                              "downsample_global.weight")) or (
                    p.dim() == 2 and name.endswith(".weight")
                    and name.startswith(("linear_", "backbone."))):
                # dense weights (O, I) and 1x1 convs (O, I, 1, 1, 1): fan-in
                # I
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
            elif name.endswith(("relative_position_bias_table",
                                "rel_pos_bias_affine_emb", "global_token",
                                "pos_embed")):
                p.normal_(0.0, 0.5, generator=gen)
            elif name.startswith(("encoder", "vit", "backbone")) and \
                    name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=gen)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.3, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=gen)
    return model.eval()


def _model_vs_cpu(tag, cfg, want, x_in, xb, other_routes=None, ref=None,
                  held=False):
    """The full-width model of ``cfg`` with seeded weights: bf16 + kernels
    on the card against fp32 + plain on the CPU on the one window ``x_in``
    (the encoder's pyramid, where the model has an ``encoder``, and the
    logits within MODEL_REL_TOL; ``ref``: the reference's logits, computed
    before on the same weights), then one predictor call on the windows
    ``xb`` (CPU tensors): its launches, which must be ``want`` (0 for every
    other kernel), on the tensor-core routes but for ``other_routes``
    ({kernel: launches}), with ``held`` every K1 and K2 launch held against
    its plain version (``_held_launches``); then peak memory and the call's
    ms with the kernels and with their plain versions. Returns (the call's
    launches, the reference's logits)."""
    import copy

    import torch

    gen = torch.Generator().manual_seed(cfg.seed)
    model = _seeded_model(cfg, gen)
    # the encoder's pyramid of the same two forwards: the logits lean on
    # the full-resolution skip, the deepest scale only on the encoder
    pyramids, hooks = [], []
    with torch.inference_mode():
        cpu_s = 0.0
        if ref is None:
            cpu = copy.deepcopy(model)
            cpu.dtype = torch.float32
            if hasattr(model, "encoder"):
                hooks = [m.encoder.register_forward_hook(
                    lambda mod, args, out: pyramids.append(
                        [o.float().cpu() for o in out])) for m in (cpu, model)]
            t0 = time.perf_counter()
            ref = cpu(x_in)
            cpu_s = time.perf_counter() - t0
            del cpu
        gpu = model.to("cuda")
        got = gpu(tuple(t.to("cuda") for t in x_in))
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        if pyramids:
            scales = [float((g - w).norm() / w.norm())
                      for w, g in zip(*pyramids)]
            print(f"{tag} encoder pyramid, rel norm err per scale "
                  f"{' '.join(f'{v:.3e}' for v in scales)} (tol "
                  f"{MODEL_REL_TOL})", flush=True)
            _require(len(scales) == 5 and max(scales) <= MODEL_REL_TOL,
                     f"{tag}: the encoder's bf16 pyramid disagrees with the "
                     "fp32 CPU reference")
            del pyramids
        shape = tuple(x_in[0].shape[:4]) + (cfg.output_dim,)
        _require(tuple(got.shape) == shape and got.dtype == torch.float32,
                 f"{tag}: logits {tuple(got.shape)} {got.dtype}")
        _require(bool(torch.isfinite(got).all()), f"{tag}: non-finite logits")
        got = got.cpu()
        rel = float((got - ref).norm() / ref.norm())
        agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        print(f"{tag} {x_in[0].shape[1]}^3, bf16+kernels (card) vs fp32 "
              f"plain (CPU"
              f"{f', {cpu_s:.1f} s' if cpu_s else ''}): rel norm err "
              f"{rel:.3e} (tol {MODEL_REL_TOL}), argmax agreement "
              f"{agree:.4f}", flush=True)
        _require(rel <= MODEL_REL_TOL, f"{tag}: bf16 card logits disagree "
                 "with the fp32 CPU reference")
        del got

        xb = tuple(t.to("cuda") for t in xb)
        n = xb[0].shape[0]
        _reset_launches()
        with (_held_launches() if held else contextlib.nullcontext()) as hl:
            out = gpu(xb)
            torch.cuda.synchronize()
        launches = _read_launches()
        _check_routes(tag, "tensor_core", need=bool(want),
                      other_routes=other_routes)
        _require(tuple(out.shape) == (n,) + shape[1:]
                 and bool(torch.isfinite(out).all()),
                 f"{tag}: logits of {n} windows")
        del out
        _require_launches(f"{tag} (one predictor call)", launches,
                          {**dict.fromkeys(launches, 0), **want})
        for name, errs in (hl.errors.items() if held else ()):
            _require(len(errs) == launches[name], f"{tag}: {name} held "
                     f"{len(errs)} of {launches[name]} launches")
            if errs:
                worst = max(errs, key=lambda e: e[1])
                print(f"{tag}: each of the {len(errs)} {name} launches "
                      f"against its plain version: worst max_abs_err "
                      f"{worst[1]:.3e} at {worst[0]} (tol {KERNEL_ATOL} + "
                      f"{KERNEL_RTOL}*|ref|)", flush=True)
                _require(all(e[2] for e in errs), f"{tag}: a {name} launch "
                         "disagrees with its plain version")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gpu(xb)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()

        def call_ms(plain):
            if plain:
                with _plain_kernels():
                    return _time_ms(lambda: gpu(xb), 2)
            return _time_ms(lambda: gpu(xb), 2)

        ms = [call_ms(plain) for plain in (False, True, True, False)]
        print(f"{tag} one predictor call ({n} windows): kernels {ms[0]:.1f} "
              f"ms, plain {ms[1]:.1f}, plain {ms[2]:.1f}, kernels "
              f"{ms[3]:.1f}; peak device memory {peak / 2 ** 30:.2f} GiB; "
              f"launches { {k: v for k, v in launches.items() if v} }",
              flush=True)
    del model, gpu, xb
    torch.cuda.empty_cache()
    return launches, ref


def phase_zoo():
    """GCViTUNETR, SegFormer3D and SwinSegFormer at the full default widths:
    bf16 + kernels on the card against fp32 + plain on the CPU on one window,
    then one predictor call of 16 windows: launch counts, ms with the kernels
    and with their plain versions, peak device memory."""
    import torch

    from medicalsemseg_tpu_torch.config import get_args

    total = None
    for name in ZOO_MODELS:
        cfg = get_args(_zoo_args(name))
        gen = torch.Generator().manual_seed(cfg.seed + 1)
        vol = torch.randn(1, 96, 96, 96, 1, generator=gen)
        x_in = (vol, torch.full((1, 3), 0.5), torch.ones(1, 3))
        xb = tuple(torch.cat([t] * PREDICT_BATCH) for t in x_in)
        launches, _ = _model_vs_cpu(f"zoo: {name}", cfg,
                                    ZOO_LAUNCHES[name], x_in, xb)
        total = launches if total is None else {
            k: total[k] + v for k, v in launches.items()}
    return total


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


CLI_SHAPES = ((240, 240, 140), (200, 180, 120))


def phase_cli():
    """The prediction CLI on two synthetic CT volumes; the kernels' launch
    counts must be 8 per predictor call (8 Swin blocks). Then the smaller
    volume again with --model GCViTUNETR and --model SegFormer3D (their
    counts per call as in the zoo phase), and with the flagship and
    --tta_mirror (8 model calls per window batch)."""
    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.cli import run_test
    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.data import nifti

    shapes = CLI_SHAPES
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        # Task01: both volumes; Task02: the smaller one alone
        for task, ids in (("Task01_SmokeCT", (0, 1)), ("Task02_SmokeSmall", (1,))):
            os.makedirs(os.path.join(tmp, task, "imagesTs"))
            with open(os.path.join(tmp, task, "dataset.json"), "w") as f:
                json.dump({"training": [], "test": [
                    f"./imagesTs/img{i}.nii.gz" for i in ids]}, f)
        for i, shape in enumerate(shapes):
            path = os.path.join(tmp, "Task01_SmokeCT", "imagesTs",
                                f"img{i}.nii.gz")
            nifti.save(nifti.NiftiImage(_ct_volume(rng, shape),
                                        np.diag([0.8, 0.8, 2.5, 1.0])), path)
        os.link(path, os.path.join(tmp, "Task02_SmokeSmall", "imagesTs",
                                   "img1.nii.gz"))

        total = {}

        def run(label, model_args, task, ids, extra=()):
            """One run of the CLI, the counts set to 0 just before it; its
            records and the launches it made."""
            out_dir = os.path.join(tmp, "out_" + label)
            cfg = get_args(model_args + list(extra) + [
                "--data_path", tmp, "--task", task, "--output_dir", out_dir,
                "--device", "cuda"])
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t0 = time.perf_counter()
            records = run_test.main(cfg)
            wall = time.perf_counter() - t0
            delta = _read_launches()
            _check_routes(f"cli {label}", "tensor_core")
            for k, v in delta.items():
                total[k] = total.get(k, 0) + v
            peak = torch.cuda.max_memory_allocated()
            calls = sum(r["predictor_calls"] for r in records)
            _require(len(records) == len(ids) and calls > 0,
                     f"cli {label}: {len(records)} volumes, {calls} predictor "
                     "calls")
            for i in ids:
                path = os.path.join(out_dir, "test_output", "Fold0", "pred",
                                    f"{i}.nii.gz")
                _require(os.path.exists(path), f"cli {label}: no prediction "
                         f"{path}")
                pred = nifti.load(path).data
                _require(pred.shape == shapes[i],
                         f"cli {label}: pred {pred.shape} != {shapes[i]}")
                if label == "nnFormerUNETR":   # the dist phase's reference
                    _CLI_PREDS[i] = pred
                _require(pred.dtype == np.uint8 and int(pred.max()) < 14,
                         f"cli {label}: pred labels out of range")
            for r in records:
                print(f"cli: {label} {r['name']} {r['shape']}: {r['windows']} "
                      f"windows, {r['predictor_calls']} predictor calls, "
                      f"predicted in {r['predict_seconds']:.2f} s, written in "
                      f"{r['seconds']:.2f} s", flush=True)
            print(f"cli: {label}: {len(records)} volumes in {wall:.2f} s, peak "
                  f"device memory {peak / 2 ** 30:.2f} GiB, launches "
                  f"{ {k: v for k, v in delta.items() if v} }", flush=True)
            return records, calls, delta

        _, calls, delta = run("nnFormerUNETR", FLAGSHIP_ARGS, "Task01_SmokeCT",
                              (0, 1))
        _require_launches(f"cli ({calls} predictor calls)", delta, {
            **dict.fromkeys(delta, 0), "window_attention": 8 * calls,
            "fused_mlp": 8 * calls})
        small_calls = None
        for name in ("GCViTUNETR", "SegFormer3D"):
            records, calls, delta = run(name, _zoo_args(name),
                                        "Task02_SmokeSmall", (1,))
            small_calls = calls
            _require_launches(f"cli {name} ({calls} predictor calls)", delta, {
                **dict.fromkeys(delta, 0),
                **{k: n * calls for k, n in ZOO_LAUNCHES[name].items()}})
        # mirror TTA: 8 model calls for each of the plain run's window batches
        records, calls, delta = run("tta_mirror", FLAGSHIP_ARGS,
                                    "Task02_SmokeSmall", (1,), ["--tta_mirror"])
        _require(calls == 8 * small_calls, f"cli tta_mirror: {calls} model "
                 f"calls, want 8 x {small_calls}")
        _require_launches(f"cli tta_mirror ({calls} model calls)", delta, {
            **dict.fromkeys(delta, 0), "window_attention": 8 * calls,
            "fused_mlp": 8 * calls})
        return total


def _reset_launches():
    from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8
    from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5
    from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr
    from medicalsemseg_tpu_torch.ops.kernels import conv3d as k10
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa
    from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

    kwa.launches = kwa.bwd_launches = kmlp.launches = kmlp.bwd_launches = 0
    k5.launches = k8.launches = k8.bwd_launches = 0
    kga.launches = ksr.launches = 0
    k9.launches = k10.launches = 0
    for by in (kwa.route_launches, kwa.bwd_route_launches,
               kga.route_launches, kmlp.route_launches,
               kmlp.bwd_route_launches, kwa.gemm_route_launches,
               kwa.bwd_gemm_route_launches, kga.gemm_route_launches,
               ksr.route_launches, k10.route_launches, k5.route_launches,
               k9.route_launches):
        for route in by:
            by[route] = 0


def _read_launches():
    from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8
    from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5
    from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr
    from medicalsemseg_tpu_torch.ops.kernels import conv3d as k10
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa
    from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

    return {"window_attention": kwa.launches, "fused_mlp": kmlp.launches,
            "winograd_conv3d_f23": k9.launches, "conv3x3x3": k10.launches,
            "window_attention_bwd": kwa.bwd_launches,
            "fused_mlp_bwd": kmlp.bwd_launches, "dw27": k5.launches,
            "global_window_attention": kga.launches,
            "sr_attention": ksr.launches,
            "dice_ce_sums": k8.launches, "dice_ce_dlogits": k8.bwd_launches}


SWIN_KERNELS = ("window_attention", "fused_mlp", "window_attention_bwd",
                "fused_mlp_bwd")
# Under the default --remat conv (as in the JAX package) each Swin block of
# the Swin UNETR models runs its forward again in the backward
# (models/layers.py checkpoint_block): a training step launches K1 and K2
# twice a block, K3 and K4 once. The recompute keeps the conv outputs, so
# K9 (MEDSEG_WINOGRAD_TRAIN) and K5 launch as without remat.
REMAT_FORWARDS = 2


def _swin_step_launches(blocks, kernels=SWIN_KERNELS):
    """The launches of ``kernels`` (of K1-K4) in training steps through
    ``blocks`` checkpointed Swin blocks in all (blocks a step times
    steps)."""
    return {k: blocks if k.endswith("_bwd") else REMAT_FORWARDS * blocks
            for k in kernels}


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
        from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
        from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
        from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr
        from medicalsemseg_tpu_torch.ops.kernels import conv3d as k10
        from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa
        from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

        names = ((kwa, "window_attention"), (kwa, "window_attention_bwd"),
                 (kmlp, "fused_mlp"), (kmlp, "fused_mlp_bwd"), (k5, "dw27"),
                 (kga, "global_window_attention"), (ksr, "sr_attention"),
                 (k8, "dice_ce_sums"), (k8, "dice_ce_dlogits"),
                 (k9, "winograd_conv3d_f23"))
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in names]
        for mod, name in names:
            setattr(mod, name, getattr(mod, name + "_plain"))
        self.saved.append((k10, "conv3x3x3_fwd", k10.conv3x3x3_fwd))
        k10.conv3x3x3_fwd = k10.conv3x3x3_plain

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
    """One seeded generator for every DropPath and Dropout of ``net``."""
    import torch

    from medicalsemseg_tpu_torch.models.layers import Dropout, DropPath

    g = torch.Generator(device="cuda").manual_seed(seed)
    for mod in net.modules():
        if isinstance(mod, (DropPath, Dropout)):
            mod.generator = g


def _grads_of(net, loss_fn, batch):
    """Loss and fp32 copies of every parameter gradient of one training-mode
    forward and backward, with the DropPath and Dropout draws seeded."""
    import torch

    from medicalsemseg_tpu_torch.train.state import _deep_supervision_loss

    _seed_drop_path(net, 7)
    net.train()
    logits = net((batch["image"], batch["crop_loc"], batch["affine"]))
    loss = (_deep_supervision_loss(loss_fn, logits, batch["label"])
            if isinstance(logits, list) else loss_fn(logits, batch["label"]))
    params = list(net.parameters())
    # the last stage's gt_upsample (--global_token) does not reach the loss
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p, dtype=torch.float32)
                                  if g is None else g.float()
                                  for p, g in zip(params, grads)]


def _block_inputs(model, run, cls):
    """(what ``run(model)`` returned, {name: (args, kwargs)}): the detached
    inputs of every block of class ``cls`` in that forward, positional and
    by keyword."""
    import torch

    def detached(v):
        return v.detach() if isinstance(v, torch.Tensor) else v

    inputs = {}
    hooks = [blk.register_forward_pre_hook(
        lambda mod, args, kwargs, name=name: inputs.__setitem__(
            name, ([detached(a) for a in args],
                   {k: detached(v) for k, v in kwargs.items()})),
        with_kwargs=True)
        for name, blk in model.named_modules() if isinstance(blk, cls)]
    result = run(model)
    for h in hooks:
        h.remove()
    return result, inputs


def _block_grads(blk, args, kwargs):
    """([output, every input gradient, every parameter gradient] as fp32,
    the names of the keyword inputs held) of one training-mode forward and
    backward of ``blk`` alone, with a seeded cotangent and seeded DropPath
    draws. A floating-point tensor among the keyword inputs is an input
    whose gradient is held too (e.g. the LayerNorm rows ``ln`` of a
    ``WindowAttention``); of a tuple output (a SwinBlock's (x, gt)) the
    first entry is held."""
    import torch

    _seed_drop_path(blk, 11)
    x = args[0].clone().requires_grad_()
    kw = {k: v.clone().requires_grad_()
          if isinstance(v, torch.Tensor) and v.is_floating_point() else v
          for k, v in kwargs.items()}
    extra = [k for k, v in kw.items() if isinstance(v, torch.Tensor)
             and v.requires_grad]
    y = blk(x, *args[1:], **kw)
    if isinstance(y, tuple):
        y = y[0]
    cot = torch.randn(y.shape, device="cuda", dtype=y.dtype,
                      generator=torch.Generator(device="cuda").manual_seed(3))
    grads = torch.autograd.grad(
        (y.float() * cot.float()).sum(),
        [x] + [kw[k] for k in extra] + list(blk.parameters()),
        allow_unused=True)
    return ([y.detach().float()] + [None if g is None else g.float()
                                    for g in grads], extra)


def _block_errors(blk, args, kwargs, ctx):
    """Relative error norms ({"y", "dx", "d<keyword input>", parameter
    name: err}) of ``_block_grads`` inside ``ctx()`` against the same inside
    ``_plain_kernels()``."""
    with ctx():
        a, extra = _block_grads(blk, args, kwargs)
    with _plain_kernels():
        b, _ = _block_grads(blk, args, kwargs)
    labels = (["y", "dx"] + [f"d{k}" for k in extra]
              + [n for n, _ in blk.named_parameters()])
    return {n: float((u - v).norm() / v.norm())
            for n, u, v in zip(labels, a, b) if v is not None}


def _blocks_vs_plain(phase, model, run, cls):
    """Each block of class ``cls`` on its own, the kernels against their
    plain versions (both bf16): the block's inputs from the training-mode
    forward of ``run(model)``, a seeded cotangent standing for the rest of
    the network, and the block's output, every input gradient and every
    parameter gradient within TRAIN_BLOCK_REL_TOL (inside the whole model a
    deep block's gradients sit at their noise floor, PERF.md). Returns
    (what ``run`` returned, the number of blocks)."""
    import contextlib

    result, inputs = _block_inputs(model, run, cls)
    for name, (args, kwargs) in inputs.items():
        errs = _block_errors(model.get_submodule(name), args, kwargs,
                             contextlib.nullcontext)
        worst = max(errs, key=errs.get)
        print(f"{phase}: {name} alone (input {tuple(args[0].shape)}), "
              f"kernels vs plain, bf16: y {errs['y']:.3e}, dx "
              f"{errs['dx']:.3e}, worst of {len(errs) - 2} other gradients "
              f"{worst} {errs[worst]:.3e} (tol {TRAIN_BLOCK_REL_TOL})",
              flush=True)
        _require(errs[worst] <= TRAIN_BLOCK_REL_TOL, f"{phase}: {name}: "
                 f"{worst} with the kernels is off by {errs[worst]:.3e}")
    return result, len(inputs)


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
        try:
            m = train_step(state, batch)
        except torch.cuda.OutOfMemoryError:
            raise PhaseError(
                f"zoo_train {name}: batch {batch_size} no longer fits the "
                "card's memory (peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
                "when it ran out)") from None
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        _require(all(bool(torch.isfinite(v).all()) for v in m.values()),
                 f"train: non-finite metrics at step {len(losses) - 1}")
    launches = _read_launches()
    _check_routes("train", "tensor_core")
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
    # 8 Swin blocks per step, recomputed (REMAT_FORWARDS); batch 8 of 96^3
    # is 7.08M voxels, over the window of K5's gate, and the loss is the
    # unfused one
    _require_launches(f"train ({TRAIN_STEPS} steps)", launches, {
        **dict.fromkeys(launches, 0),
        **_swin_step_launches(8 * TRAIN_STEPS)})

    # one step's gradients: bf16 + kernels vs fp32 + plain
    del state, m
    loss_fn = build_loss(cfg)
    small = {k: v[:TRAIN_GRAD_BATCH] for k, v in batch.items()}

    def grads_of(net):
        return _grads_of(net, loss_fn, small)

    (got_loss, got), found = _blocks_vs_plain("train", model, grads_of,
                                              SwinBlock)
    _require(found == 8, f"train: {found} Swin blocks found")
    with _plain_kernels():
        mid_loss, mid = grads_of(model)

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


class _env_var:
    """The environment variable ``name`` set to ``value`` (None: unset)
    inside the block."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.saved = os.environ.pop(self.name, None)
        if self.value is not None:
            os.environ[self.name] = self.value

    def __exit__(self, *exc):
        os.environ.pop(self.name, None)
        if self.saved is not None:
            os.environ[self.name] = self.saved


def _dw27_mode(mode):
    """MEDSEG_DW27_PALLAS set to ``mode`` (None: unset, the auto gate)
    inside the block."""
    return _env_var("MEDSEG_DW27_PALLAS", mode)


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
        _check_routes("train_b4", "tensor_core")
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
        **_swin_step_launches(8 * n), "dw27": 3 * n,
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
    """torch.profiler over one warm training step at batch 8 of the
    flagship, SwInception and SwinDepth, one warm micro-step at batch 4 with
    the fused loss, and one warm predictor call of 16 windows of each zoo
    model and of SwInception and SwinDepth: device time by kernel name, for
    PERF.md's "where the time goes"."""
    with _dw27_mode(None):
        _profile_step(TRAIN_BATCH, ())
        _profile_step(TRAIN_B4_BATCH, TRAIN_B4_FLAGS)
        for name in SWIN_MLP_MODELS:
            _profile_step(TRAIN_BATCH, ("--model", name))
    for name in ZOO_MODELS + SWIN_MLP_MODELS:
        _profile_call(name)
    _profile_call("nnFormerUNETR")
    _profile_call("nnFormerUNETR", "MEDSEG_FUSED_DECODER")


def phase_profile_official():
    """torch.profiler over one warm training step at batch 8 (nnFormer with
    --deep_supervision) and one warm predictor call of 16 windows of each
    zoo_official model, SwinUNETR_Official's call also with
    MEDSEG_OFFICIAL_FUSED=1 (read when the model is built)."""
    with _dw27_mode(None):
        for name in ZOO_OFFICIAL_MODELS:
            _profile_step(TRAIN_BATCH, ("--model", name,
                                        *ZOO_OFFICIAL_TRAIN_FLAGS[name]))
    for name in ZOO_OFFICIAL_MODELS:
        _profile_call(name)
    with _env_var(OFFICIAL_GATE, "1"):
        _profile_call("SwinUNETR_Official", note=f" {OFFICIAL_GATE}=1")


K9_PARTS = (("whole", 0), ("without the V build", 1),
            ("without the products and folds", 2), ("without the u copies", 4),
            ("without staging x", 8), ("staging, u copies and output only", 3),
            ("output and barriers only", 15))


def phase_k9_parts():
    """K9 at 16 x 96^3, 48 -> 48, built with parts compiled out
    (MEDSEG_K9_SKIP in csrc/winograd3d.cu): what each part costs, where no
    kernel profiler runs. The variants' results are wrong by design; only
    the whole kernel is compared with the library's conv."""
    import ctypes

    import torch

    from medicalsemseg_tpu_torch.ops import kernels
    from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

    out_dir = os.path.join(kernels.BUILD_DIR, "k9_parts")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(kernels.CSRC_DIR, "winograd3d.cu")
    jobs = []
    for _, mask in K9_PARTS:
        so = os.path.join(out_dir, f"k9_skip_{mask}.so")
        jobs.append((so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
             f"-DMEDSEG_K9_SKIP={mask}", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, edge, c = PREDICT_BATCH, CROP, 48
    x = torch.randn(b, edge, edge, edge, c, generator=gen,
                    device="cuda").to(torch.bfloat16)
    w = (torch.randn(c, c, 3, 3, 3, generator=gen, device="cuda")
         * (27 * c) ** -0.5).to(torch.bfloat16)
    u = k9.kernel_weights_f23(k9._transform_weights(w).to(torch.bfloat16))
    y = torch.empty_like(x)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for (label, mask), (so, proc) in zip(K9_PARTS, jobs):
        out, err = proc.communicate()
        _require(proc.returncode == 0, f"k9_parts: nvcc failed:\n{out}\n{err}")
        fn = ctypes.CDLL(so).medseg_winograd_f23
        fn.argtypes, fn.restype = [p] * 4 + [i] * 9 + [f, i, i, p], i

        def launch():
            # bf16 (dtype code 0) on the tensor-core route
            rc = fn(kernels.ptr(x), kernels.ptr(u), None, kernels.ptr(y), b,
                    edge, edge, edge, c, c, u.shape[1] * k9.CHUNK_CHANNELS,
                    u.shape[0] * k9.CHUNK_CHANNELS, 0, 0.01, 0,
                    kernels.ROUTES["tensor_core"],
                    kernels.stream_handle(x.device))
            _require(rc == 0, f"k9_parts: launch failed ({rc})")

        ms = _time_ms(launch, 5)
        if mask == 0:
            lib = _lib_conv(x, w).permute(0, 2, 3, 4, 1).float()
            rel = float((y.float() - lib).norm() / lib.norm())
            _require(rel <= 2e-2, f"k9_parts: the whole kernel is {rel:.2e} "
                     "from the library's conv")
        print(f"k9_parts: 16x96^3, 48->48, kernel alone, {label}: "
              f"{ms:.3f} ms", flush=True)


# MEDSEG_ATTN_SKIP bits (csrc/mma_tile.cuh): 1 LayerNorm statistics and
# staging loads, 2 the softmax's elementwise work, 4 the launches after the
# heads launch, 8 K3's bias partials, 16 K3's dv and dk products; in the
# tensor-core GEMM launches (K1's projection, K3's dx and dw): 32 staging
# loads, 64 the LayerNorm, 128 dw's flushes, 256 the epilogues, 512 the dw
# launch; 1024 the heads launch, so that the GEMM launches (and K3's sums
# of partials) are timed alone
ATTN_PARTS = (("whole", 0), ("heads launch alone", 4),
              ("heads alone, without statistics and staging loads", 5),
              ("heads alone, without the softmax's elementwise work", 6),
              ("heads alone, without the bias partials (K3)", 12),
              ("heads alone, without dv and dk (K3)", 20),
              ("heads alone, products and barriers only", 31),
              ("GEMM launches alone", 1024),
              ("GEMM alone, without their staging loads", 1056),
              ("GEMM alone, without the LayerNorm", 1088),
              ("GEMM alone, dw without its flushes (K3)", 1152),
              ("GEMM alone, without their epilogues", 1280),
              ("GEMM alone, dx without dw (K3)", 1536),
              ("GEMM alone, products and barriers only", 1504))


def phase_attn_parts():
    """K1 (one predictor call's windows) and K3 (one training step's) on the
    tensor cores at the first two stages, built with parts compiled out
    (MEDSEG_ATTN_SKIP in csrc/mma_tile.cuh): what each part costs, where no
    kernel profiler runs (CUDA events: torch.profiler, which times each
    launch in the kernels phase, lost launches of the variant libraries).
    The variants' results are wrong by design; the whole build is compared
    with the library's."""
    import ctypes
    import types

    import torch

    from medicalsemseg_tpu_torch.ops import kernels
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    out_dir = os.path.join(kernels.BUILD_DIR, "attn_parts")
    os.makedirs(out_dir, exist_ok=True)
    srcs = [os.path.join(kernels.CSRC_DIR, f) for f in
            ("window_attention.cu", "window_attention_bwd.cu", "reduce.cu")]
    jobs = []
    for _, mask in ATTN_PARTS:
        so = os.path.join(out_dir, f"attn_skip_{mask}.so")
        jobs.append((so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
             f"-DMEDSEG_ATTN_SKIP={mask}", "-o", so, *srcs],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))

    class _Known:
        """The variant library, with argtypes rows set only for the entry
        points it has."""

        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return getattr(self.lib, name, types.SimpleNamespace())

    main = kernels.load()
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for grid, c, nh in STAGES[:2]:
        wins, a, kw = _attn_case(gen, PREDICT_BATCH, grid, c, nh, 0, True,
                                 True)
        cases.append((f"K1 x{PREDICT_BATCH} C={c}", lambda w=wins, a=a, kw=kw:
                      kwa.window_attention(w, **a, **kw)))
        wins, a, kw = _attn_case(gen, TRAIN_BATCH, grid, c, nh, 0, True,
                                 False)
        dy = torch.randn(wins.shape, generator=gen,
                         device="cuda").to(wins.dtype)
        b = {k: v for k, v in a.items() if k != "bproj"}
        cases.append((f"K3 x{TRAIN_BATCH} C={c}", lambda w=wins, b=b, kw=kw,
                      dy=dy: kwa.window_attention_bwd(w, dy=dy, **b, **kw)))
    want = [fn() for _, fn in cases]
    try:
        for (label, mask), (so, proc) in zip(ATTN_PARTS, jobs):
            out, err = proc.communicate()
            _require(proc.returncode == 0,
                     f"attn_parts: nvcc failed:\n{out}\n{err}")
            lib = ctypes.CDLL(so)
            kernels._declare(_Known(lib))
            kernels._lib = lib
            for (name, fn), ref in zip(cases, want):
                if mask == 0:
                    got = fn()
                    got = got if isinstance(got, tuple) else (got,)
                    ref = ref if isinstance(ref, tuple) else (ref,)
                    _require(all(g is None or torch.equal(g, r)
                                 for g, r in zip(got, ref)),
                             f"attn_parts: {name}: the whole build differs "
                             "from the library's")
                print(f"attn_parts: {name}, {label}: "
                      f"{_time_ms(fn, 5):.3f} ms", flush=True)
    finally:
        kernels._lib = main


# MEDSEG_SR_SKIP bits (csrc/sr_attention.cu): 1 the copies of the token
# tiles, K and V, 2 the softmax's elementwise work, 4 the output projection's
# products, 8 the epilogue (stores; with head groups the cluster's sum).
SR_PARTS = (("whole", 0), ("without the copies", 1),
            ("without the softmax's elementwise work", 2),
            ("without the projection's products", 4),
            ("without the epilogue", 8),
            ("q, scores and P . V products only", 15))


def phase_sr_parts():
    """The tensor-core K7 at the four SegFormer3D stages of one predictor
    call, built with parts compiled out (MEDSEG_SR_SKIP in
    csrc/sr_attention.cu), each timed on the device
    (_queued_ms: CUDA events over calls queued behind a sleep kernel, so
    that the host's cost per call does not bound them); then the host's time
    a call. The variants' results are wrong by design; the whole build is
    compared with the library's."""
    import ctypes
    import types

    import torch

    from medicalsemseg_tpu_torch.ops import kernels
    from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr

    out_dir = os.path.join(kernels.BUILD_DIR, "sr_parts")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(kernels.CSRC_DIR, "sr_attention.cu")
    jobs = []
    for _, mask in SR_PARTS:
        so = os.path.join(out_dir, f"sr_skip_{mask}.so")
        jobs.append((so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
             f"-DMEDSEG_SR_SKIP={mask}", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))

    class _Known:
        """The variant library, with argtypes rows set only for the entry
        points it has."""

        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return getattr(self.lib, name, types.SimpleNamespace())

    main = kernels.load()
    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = []
    with torch.inference_mode():
        for ntok, c, nh in SR_STAGES:
            x, a = _sr_case(gen, PREDICT_BATCH, ntok, c, nh, True, True)
            cases.append((f"K7 x{PREDICT_BATCH} C={c}",
                          lambda x=x, a=a: ksr.sr_attention(x, **a)))
        want = [fn() for _, fn in cases]
        try:
            for (label, mask), (so, proc) in zip(SR_PARTS, jobs):
                out, err = proc.communicate()
                _require(proc.returncode == 0,
                         f"sr_parts: nvcc failed:\n{out}\n{err}")
                lib = ctypes.CDLL(so)
                kernels._declare(_Known(lib))
                kernels._lib = lib
                for (name, fn), ref in zip(cases, want):
                    if mask == 0:
                        _require(torch.equal(fn(), ref),
                                 f"sr_parts: {name}: the whole build differs "
                                 "from the library's")
                    print(f"sr_parts: {name}, {label}: "
                          f"{_queued_ms(fn, 10):.4f} ms", flush=True)
        finally:
            kernels._lib = main
        # the host's cost of a call: the wrapper's checks and the launch
        name, fn = cases[-1]
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host = (time.perf_counter() - t0) / 200
        torch.cuda.synchronize()
        print(f"sr_parts: {name}: {host * 1e3:.4f} ms of host time a call",
              flush=True)


# MEDSEG_MLP_SKIP bits (csrc/mlp_tile.cuh): 1 LayerNorm statistics and
# token-tile staging loads, 2 the GELU / GELU' elementwise work, 4 the weight
# staging, 8 K4's dW flushes and partials, 16 K4's dhb store, 32 K4's dx
# launch. K2 has the first three parts only.
MLP_PARTS = (("whole", 0),
             ("without statistics and token staging", 1),
             ("without the GELU / GELU' elementwise work", 2),
             ("without the weight staging", 4),
             ("without the dW flushes and partials (K4)", 8),
             ("without the dhb store (K4)", 16),
             ("weight-gradient launch alone (K4)", 32),
             ("weight-gradient launch alone, without GELU' (K4)", 34),
             ("products, output stores and barriers only", 7),
             ("... and without the flushes and the dhb store (K4)", 31))


def phase_mlp_parts():
    """The tensor-core K2 (one predictor call's tokens) and K4 (one training
    step's) at the four stages, built with parts compiled out
    (MEDSEG_MLP_SKIP in csrc/mlp_tile.cuh), as phase_attn_parts does for the
    attention kernels. The variants' results are wrong by design; the whole
    build is compared with the library's."""
    import ctypes
    import types

    import torch

    from medicalsemseg_tpu_torch.ops import kernels
    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp

    out_dir = os.path.join(kernels.BUILD_DIR, "mlp_parts")
    os.makedirs(out_dir, exist_ok=True)
    srcs = [os.path.join(kernels.CSRC_DIR, f) for f in
            ("mlp.cu", "mlp_bwd.cu", "reduce.cu")]
    jobs = []
    for _, mask in MLP_PARTS:
        so = os.path.join(out_dir, f"mlp_skip_{mask}.so")
        jobs.append((so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
             f"-DMEDSEG_MLP_SKIP={mask}", "-o", so, *srcs],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))

    class _Known:
        """The variant library, with argtypes rows set only for the entry
        points it has."""

        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return getattr(self.lib, name, types.SimpleNamespace())

    main = kernels.load()
    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = []
    for grid, c, _ in STAGES:
        x, a, kw = _mlp_case(gen, PREDICT_BATCH, grid, c, True, True)
        cases.append((f"K2 x{PREDICT_BATCH} C={c}", 7,
                      lambda x=x, a=a, kw=kw: kmlp.fused_mlp(x, **a, **kw)))
        x, a, kw = _mlp_case(gen, TRAIN_BATCH, grid, c, True, False)
        b = dict(w1=a["w1"], b1=a["b1"], w2=a["w2"], ln=kw["ln"],
                 dy=torch.randn(x.shape, generator=gen,
                                device="cuda").to(x.dtype))
        cases.append((f"K4 x{TRAIN_BATCH} C={c}", 63,
                       lambda x=x, b=b: kmlp.fused_mlp_bwd(x, **b)))
    want = [fn() for _, _, fn in cases]
    try:
        for (label, mask), (so, proc) in zip(MLP_PARTS, jobs):
            out, err = proc.communicate()
            _require(proc.returncode == 0,
                     f"mlp_parts: nvcc failed:\n{out}\n{err}")
            lib = ctypes.CDLL(so)
            kernels._declare(_Known(lib))
            kernels._lib = lib
            for (name, bits, fn), ref in zip(cases, want):
                if mask & ~bits:
                    continue
                if mask == 0:
                    got = fn()
                    got = got if isinstance(got, tuple) else (got,)
                    ref = ref if isinstance(ref, tuple) else (ref,)
                    _require(all(torch.equal(g, r) for g, r in zip(got, ref)),
                             f"mlp_parts: {name}: the whole build differs "
                             "from the library's")
                print(f"mlp_parts: {name}, {label}: "
                      f"{_time_ms(fn, 5):.3f} ms", flush=True)
    finally:
        kernels._lib = main


K5_PARTS = (("whole", 0), ("without the products", 1),
            ("without the row copies", 2), ("without the flushes", 4),
            ("products only", 6), ("barriers and walk only", 7))


def phase_k5_parts():
    """K5's tensor-core kernel at batch 4 of 96^3, 96 -> 48, built with parts
    compiled out (MEDSEG_K5_SKIP in csrc/dw27.cu), as phase_k9_parts does
    for K9; only the whole kernel is compared with its plain version."""
    import ctypes

    import torch

    from medicalsemseg_tpu_torch.ops import kernels
    from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5

    out_dir = os.path.join(kernels.BUILD_DIR, "k5_parts")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(kernels.CSRC_DIR, "dw27.cu")
    masks = sorted({mask for _, mask in K5_PARTS})
    jobs = {}
    for mask in masks:
        so = os.path.join(out_dir, f"k5_skip_{mask}.so")
        jobs[mask] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
             f"-DMEDSEG_K5_SKIP={mask}", "-o", so, src,
             os.path.join(kernels.CSRC_DIR, "reduce.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape, c, co = (TRAIN_B4_BATCH, CROP, CROP, CROP), 96, 48
    x = torch.randn(*shape, c, generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn(*shape, co, generator=gen,
                     device="cuda").to(torch.bfloat16)
    route = k5._ROUTE_TENSOR_CORES
    shares = k5.launch_shares(x.shape, co, route, x.device)
    part = torch.empty((shares, 27 * c * co), device="cuda")
    out = torch.empty((3, 3, 3, c, co), device="cuda")
    p, i = ctypes.c_void_p, ctypes.c_int
    for mask in masks:
        so, proc = jobs[mask]
        o, err = proc.communicate()
        _require(proc.returncode == 0, f"k5_parts: nvcc failed:\n{o}\n{err}")
    for label, mask in K5_PARTS:
        fn = ctypes.CDLL(jobs[mask][0]).medseg_dw27
        fn.argtypes, fn.restype = [p] * 4 + [i] * 8 + [p], i

        def launch():
            rc = fn(kernels.ptr(x), kernels.ptr(dy), kernels.ptr(part),
                    kernels.ptr(out), *shape, c, co, shares, route,
                    kernels.stream_handle(x.device))
            _require(rc == 0, f"k5_parts: launch failed ({rc})")

        ms = _time_ms(launch, 5)
        if mask == 0:
            want = k5.dw27_plain(x, dy)
            rel = float((out - want).norm() / want.norm())
            _require(rel <= 1e-5, f"k5_parts: the whole kernel is {rel:.2e} "
                     "from its plain version")
        print(f"k5_parts: {TRAIN_B4_BATCH}x{CROP}^3, {c}->{co}, kernel alone, "
              f"{label}: {ms:.3f} ms", flush=True)


# MEDSEG_K10_SKIP bits (csrc/conv3d.cu): 1 the staging of x, 2 the products
# (ldmatrix and wgmma), 4 the epilogue, 8 the weight copies
K10_PARTS = (("whole", 0), ("without the staging of x", 1),
             ("without the products", 2), ("without the epilogue", 4),
             ("without the weight copies", 8),
             ("products and weight copies only", 5),
             ("products alone", 13),
             ("staging and epilogue only", 10),
             ("walk, ring and barriers only", 15))


def phase_k10_parts():
    """K10's tensor-core route at batch 4 of 96^3, forward 48 -> 48 and dx
    48 -> 96 (blocks of 48 and 96 output channels), built with parts
    compiled out (MEDSEG_K10_SKIP in csrc/conv3d.cu), as phase_k9_parts
    does for K9; only the whole kernel is compared with its plain
    version."""
    import ctypes

    import torch

    from medicalsemseg_tpu_torch.ops import kernels
    from medicalsemseg_tpu_torch.ops.kernels import conv3d as k10

    out_dir = os.path.join(kernels.BUILD_DIR, "k10_parts")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(kernels.CSRC_DIR, "conv3d.cu")
    jobs = {}
    for _, mask in K10_PARTS:
        so = os.path.join(out_dir, f"k10_skip_{mask}.so")
        jobs[mask] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
             f"-DMEDSEG_K10_SKIP={mask}", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for mask, (so, proc) in jobs.items():
        o, err = proc.communicate()
        _require(proc.returncode == 0, f"k10_parts: nvcc failed:\n{o}\n{err}")
    gen = torch.Generator(device="cuda").manual_seed(10)
    shape = (TRAIN_B4_BATCH, CROP, CROP, CROP)
    p, i = ctypes.c_void_p, ctypes.c_int
    for what, c, co in (("fwd", 48, 48), ("dx", 48, 96)):
        x = torch.randn(*shape, c, generator=gen,
                        device="cuda").to(torch.bfloat16)
        w = (torch.randn(co, c, 3, 3, 3, generator=gen, device="cuda")
             * (27 * c) ** -0.5).to(torch.bfloat16)
        n, _ = k10.block_width(co)
        wk = k10.kernel_weights(w, n)
        cp = -(-c // k10.IN_CHANNEL_STEP) * k10.IN_CHANNEL_STEP
        y = torch.empty(*shape, co, dtype=torch.bfloat16, device="cuda")
        for label, mask in K10_PARTS:
            fn = ctypes.CDLL(jobs[mask][0]).medseg_conv3x3x3
            fn.argtypes, fn.restype = [p] * 3 + [i] * 10 + [p], i

            def launch():
                rc = fn(kernels.ptr(x), kernels.ptr(wk), kernels.ptr(y),
                        *shape, c, co, cp, n, 0, kernels.ROUTES["tensor_core"],
                        kernels.stream_handle(x.device))
                _require(rc == 0, f"k10_parts: launch failed ({rc})")

            ms = _time_ms(launch, 5)
            if mask == 0:
                want = k10.conv3x3x3_plain(x, w).float()
                rel = float((y.float() - want).norm() / want.norm())
                _require(rel <= 1e-2, f"k10_parts: the whole kernel is "
                         f"{rel:.2e} from its plain version")
            print(f"k10_parts: {what} {TRAIN_B4_BATCH}x{CROP}^3, {c}->{co}, "
                  f"{label}: {ms:.3f} ms", flush=True)
        del x, w, wk, y
        torch.cuda.empty_cache()


def _profiled(title, fn):
    """Run ``fn`` (already warm) under torch.profiler and print its device
    time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def device_us(e):  # the attribute's name changed between releases
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)

    rows = sorted(((device_us(e) / 1e3, e.count, e.key)
                   for e in prof.key_averages() if device_us(e) > 0
                   and e.device_type.name == "CUDA"), reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile: {title}: {total:.1f} ms of device kernel time in "
          f"{len(rows)} kernels", flush=True)
    for ms, count, key in rows[:60]:
        print(f"  {ms:9.2f} ms {100 * ms / total:5.1f} %  x{count:<4d} "
              f"{key[:110]}", flush=True)


def _profile_step(n_batch, extra_args):
    import torch

    cfg, model, state, train_step = _train_setup(extra_args)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = _train_batch(gen, n_batch, cfg.output_dim)
    for _ in range(2):      # with accumulation over 2 micro-steps the profiled
        train_step(state, batch)  # call is the first of a pair: no update
    _profiled(f"one training step, batch {n_batch} {' '.join(extra_args)}",
              lambda: train_step(state, batch))
    del model, state
    torch.cuda.empty_cache()


def _profile_call(name, *gates, note=""):
    import torch

    from medicalsemseg_tpu_torch.config import get_args

    cfg = get_args(FLAGSHIP_ARGS if name == "nnFormerUNETR"
                   else _zoo_args(name))
    gen = torch.Generator().manual_seed(cfg.seed)
    model = _seeded_model(cfg, gen).to("cuda")
    xb = (torch.randn(PREDICT_BATCH, 96, 96, 96, 1, generator=gen).to("cuda"),
          torch.full((PREDICT_BATCH, 3), 0.5, device="cuda"),
          torch.ones(PREDICT_BATCH, 3, device="cuda"))
    with torch.inference_mode(), _gates(*gates):
        for _ in range(2):
            model(xb)
        _profiled(f"one predictor call of {PREDICT_BATCH} windows, {name} "
                  f"{' '.join(g + '=1' for g in gates)}{note}",
                  lambda: model(xb))
    del model, xb
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
        _check_routes("train_cli", "tensor_core")
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
            _require(launches[name] > REMAT_FORWARDS * 8 * steps
                     and launches[name] % 8 == 0,
                     f"train_cli: {name} launched {launches[name]} times "
                     f"(training steps, {REMAT_FORWARDS} x 8 each, and "
                     f"validation calls, 8 each)")
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


WINO_GATES = ("MEDSEG_FUSED_DECODER", "MEDSEG_WINOGRAD", "MEDSEG_WINOGRAD_TRAIN")


class _gates:
    """Inside the block the named Winograd gates are set to 1 and the other
    two are unset."""

    def __init__(self, *on):
        self.on = on

    def __enter__(self):
        self.saved = {k: os.environ.pop(k, None) for k in WINO_GATES}
        for k in self.on:
            os.environ[k] = "1"

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def _is_conv3_s1(mod):
    from medicalsemseg_tpu_torch.models.layers import Conv3d

    return (isinstance(mod, Conv3d) and mod.kernel_size == 3
            and mod.stride == 1 and mod.groups == 1 and mod.padding == 1)


def _k9_launches_required(model, run, gate):
    """K9's launches of one ``run()`` of ``model`` under ``gate``, from the
    port's gate functions and the shapes the model gives its convs (seen by
    hooks in an ungated run): ``MEDSEG_FUSED_DECODER`` asks
    ``winograd_f23_applicable`` for conv1's output in every UnetResBlock,
    ``MEDSEG_WINOGRAD`` asks ``wino23_eligible`` for the input of every 3^3 /
    stride-1 / SAME conv, ``MEDSEG_WINOGRAD_TRAIN`` for its input (forward)
    and, where the input needs a gradient, for its output (dx runs on dy)."""
    import torch

    from medicalsemseg_tpu_torch.models.decoders import UnetResBlock
    from medicalsemseg_tpu_torch.models.layers import remat_replaying
    from medicalsemseg_tpu_torch.ops import convgrad
    from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

    count = [0]

    def conv1_hook(mod, args, out):
        count[0] += int(out.is_cuda
                        and k9.winograd_f23_applicable(tuple(out.shape[1:4]),
                                                       out.shape[-1]))

    def conv_hook(mod, args, out):
        if remat_replaying():   # the recompute keeps the forward's output
            return
        x = args[0]
        count[0] += int(convgrad.wino23_eligible(x))
        if gate == "MEDSEG_WINOGRAD_TRAIN":
            count[0] += int(x.requires_grad and convgrad.wino23_eligible(out))

    hooks = []
    for mod in model.modules():
        if gate == "MEDSEG_FUSED_DECODER" and isinstance(mod, UnetResBlock):
            hooks.append(mod.conv1.register_forward_hook(conv1_hook))
        elif gate != "MEDSEG_FUSED_DECODER" and _is_conv3_s1(mod):
            hooks.append(mod.register_forward_hook(conv_hook))
    with _gates():
        run()
    for h in hooks:
        h.remove()
    return count[0]


# K9's launches in one flagship predictor call under MEDSEG_FUSED_DECODER=1
# (conv2 of the six res blocks at 48 and 96 channels), in every dtype
WINO_FUSED_LAUNCHES = 6
# the fused call in fp16 and fp32 against the unfused call in the same dtype:
# fp16 rounds 8x finer than bf16 (2^-11 against 2^-8), so a third of the
# bf16 limit below; fp32 has no rounding to the dtype, and the Winograd sums
# differ from the direct conv's (TF32 off) by their order only
FUSED_F16_REL_TOL = 1e-2
FUSED_F32_REL_TOL = 1e-4
# one predictor call with K9 in the decoder against the same call through the
# library's convs, both bf16 with K1/K2: Winograd in bf16 carries about twice
# the direct conv's rounding (0.7 % against 0.3 % max relative error in the
# JAX package's tests) in up to 11 convs, and InstanceNorm rescales it at
# every decoder stage: the same order as bf16 against fp32 (MODEL_REL_TOL)
WINO_MODEL_REL_TOL = 3e-2


def phase_fused():
    """The no-gradient paths that run K9, at full flagship width; the fused
    decoder in bf16, fp16 and fp32."""
    import copy

    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.cli import run_test
    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.data import nifti
    from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

    total = dict.fromkeys(_read_launches(), 0)

    def add(delta):
        for k, v in delta.items():
            total[k] += v

    for model_name, gates in (("nnFormerUNETR", ("MEDSEG_FUSED_DECODER",
                                                 "MEDSEG_WINOGRAD")),
                              ("GCViTUNETR", ("MEDSEG_FUSED_DECODER",))):
        flagship = model_name == "nnFormerUNETR"
        cfg = get_args(FLAGSHIP_ARGS if flagship else _zoo_args(model_name))
        gen = torch.Generator().manual_seed(cfg.seed)
        model = _seeded_model(cfg, gen)
        vol = torch.randn(1, 96, 96, 96, 1, generator=gen)
        x_in = (vol, torch.full((1, 3), 0.5), torch.ones(1, 3))
        with torch.inference_mode():
            want = None
            if flagship:       # fp32 plain on the CPU, as the model phase
                ref = copy.deepcopy(model)
                ref.dtype = torch.float32
                want = ref(x_in)
                del ref
            gpu = model.to("cuda")
            x_gpu = tuple(t.to("cuda") for t in x_in)
            xb = tuple(torch.cat([t] * PREDICT_BATCH) for t in x_gpu)
            with _gates():
                base = gpu(x_gpu).cpu()
            for gate in gates:
                need = _k9_launches_required(gpu, lambda: gpu(xb), gate)
                _require(need > 0, f"fused {model_name} {gate}: the gate "
                         "opens for no conv")
                with _gates(gate):
                    got = gpu(x_gpu)
                    torch.cuda.synchronize()
                    _require(got.shape == (1, 96, 96, 96, 14)
                             and bool(torch.isfinite(got).all()),
                             f"fused {model_name} {gate}: logits")
                    got = got.cpu()
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    _reset_launches()
                    out = gpu(xb)
                    torch.cuda.synchronize()
                    launches = _read_launches()
                    by_route = dict(k9.route_launches)
                    peak = torch.cuda.max_memory_allocated()
                    _require(bool(torch.isfinite(out).all()),
                             f"fused {model_name} {gate}: logits of "
                             f"{PREDICT_BATCH} windows")
                    del out
                add(launches)
                for r, n in by_route.items():
                    ROUTE_TOTALS["winograd_conv3d_f23"][r] += n
                _require(by_route["tensor_core"] == need, f"fused {model_name} "
                         f"{gate}: K9 by route {by_route}")
                others = (ZOO_LAUNCHES[model_name] if not flagship else
                          {"window_attention": 8, "fused_mlp": 8})
                _require_launches(
                    f"fused {model_name} {gate} (one predictor call)", launches,
                    {**dict.fromkeys(launches, 0), **others,
                     "winograd_conv3d_f23": need})
                rel_base = float((got - base).norm() / base.norm())
                line = (f"fused: {model_name} {gate}=1, one 96^3 window, bf16: "
                        f"rel norm err vs the ungated card path "
                        f"{rel_base:.3e} (tol {WINO_MODEL_REL_TOL})")
                if want is not None:
                    rel = float((got - want).norm() / want.norm())
                    agree = float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean())
                    line += (f", vs fp32 plain (CPU) {rel:.3e} (tol "
                             f"{MODEL_REL_TOL}), argmax agreement {agree:.4f}")
                    _require(rel <= MODEL_REL_TOL, f"fused {gate}: bf16 card "
                             "logits disagree with the fp32 CPU reference")
                print(line, flush=True)
                _require(rel_base <= WINO_MODEL_REL_TOL, f"fused {model_name} "
                         f"{gate}: logits disagree with the ungated path")

                def call_ms(on):
                    with _gates(*((gate,) if on else ())):
                        torch.cuda.reset_peak_memory_stats()
                        ms = _time_ms(lambda: gpu(xb), 2)
                        return ms, torch.cuda.max_memory_allocated()

                t = [call_ms(on) for on in (True, False, False, True)]
                print(f"fused: {model_name} one predictor call "
                      f"({PREDICT_BATCH} windows), K9 launched {need} times: "
                      f"{gate}=1 {t[0][0]:.1f} ms, unset {t[1][0]:.1f}, unset "
                      f"{t[2][0]:.1f}, =1 {t[3][0]:.1f}; peak device memory "
                      f"{max(peak, t[0][1]) / 2 ** 30:.2f} GiB against "
                      f"{t[1][1] / 2 ** 30:.2f} unset", flush=True)
        del model, gpu, xb
        torch.cuda.empty_cache()

    # --compute_dtype float16 and float32 under the fused decoder, as the JAX
    # package runs them: K9 on the tensor cores and on the CUDA cores, each
    # call against the unfused call in the same dtype (TF32 off)
    cfg = get_args(FLAGSHIP_ARGS + ["--compute_dtype", "float32"])
    gen = torch.Generator().manual_seed(cfg.seed)
    model = _seeded_model(cfg, gen).to("cuda")
    xb = (torch.randn(FP16_WINDOWS, 96, 96, 96, 1, generator=gen).to("cuda"),
          torch.full((FP16_WINDOWS, 3), 0.5, device="cuda"),
          torch.ones(FP16_WINDOWS, 3, device="cuda"))
    for dt, route, tol in ((torch.float16, "tensor_core", FUSED_F16_REL_TOL),
                           (torch.float32, "cuda_core", FUSED_F32_REL_TOL)):
        dname = str(dt).split(".")[-1]
        net = copy.deepcopy(model)
        net.dtype = dt
        with torch.inference_mode(), _no_tf32():
            need = _k9_launches_required(net, lambda: net(xb),
                                         "MEDSEG_FUSED_DECODER")
            with _gates():
                base = net(xb)
            with _gates("MEDSEG_FUSED_DECODER"):
                _reset_launches()
                got = net(xb)
                torch.cuda.synchronize()
                launches = _read_launches()
                by_route = dict(k9.route_launches)
            add(launches)
            for r, n in by_route.items():
                ROUTE_TOTALS["winograd_conv3d_f23"][r] += n
            _require(need == WINO_FUSED_LAUNCHES, f"fused {dname}: the gate "
                     f"opens for {need} convs (want {WINO_FUSED_LAUNCHES})")
            _require_launches(f"fused {dname} (one predictor call)", launches,
                              {**dict.fromkeys(launches, 0),
                               "window_attention": 8, "fused_mlp": 8,
                               "winograd_conv3d_f23": need})
            _require(by_route[route] == need, f"fused {dname}: K9 by route "
                     f"{by_route} (want {need} on the {route} route)")
            _require(got.shape == (FP16_WINDOWS, 96, 96, 96, 14)
                     and bool(torch.isfinite(got).all()),
                     f"fused {dname}: logits {tuple(got.shape)}")
            rel = float((got.float() - base.float()).norm()
                        / base.float().norm())
            t = []
            for on in (True, False, False, True):
                with _gates(*(("MEDSEG_FUSED_DECODER",) if on else ())):
                    t.append(_time_ms(lambda: net(xb), 2))
        print(f"fused: nnFormerUNETR MEDSEG_FUSED_DECODER=1, --compute_dtype "
              f"{dname}, one predictor call ({FP16_WINDOWS} windows): rel "
              f"norm err vs the unfused call {rel:.3e} (tol {tol}); K9 "
              f"launches by route {by_route}; =1 {t[0]:.1f} ms, unset "
              f"{t[1]:.1f}, unset {t[2]:.1f}, =1 {t[3]:.1f}", flush=True)
        _require(rel <= tol, f"fused {dname}: logits disagree with the "
                 "unfused call")
        del net, base, got
        torch.cuda.empty_cache()
    del model, xb
    torch.cuda.empty_cache()

    # the prediction CLI on the smaller synthetic volume, fused decoder
    shape = (200, 180, 120)
    with tempfile.TemporaryDirectory() as tmp:
        task = os.path.join(tmp, "Task03_SmokeFused")
        os.makedirs(os.path.join(task, "imagesTs"))
        with open(os.path.join(task, "dataset.json"), "w") as f:
            json.dump({"training": [], "test": ["./imagesTs/img0.nii.gz"]}, f)
        nifti.save(nifti.NiftiImage(
            _ct_volume(np.random.default_rng(1), shape),
            np.diag([0.8, 0.8, 2.5, 1.0])),
            os.path.join(task, "imagesTs", "img0.nii.gz"))
        cfg = get_args(FLAGSHIP_ARGS + [
            "--data_path", tmp, "--task", "Task03_SmokeFused", "--output_dir",
            os.path.join(tmp, "out"), "--device", "cuda"])
        with _gates("MEDSEG_FUSED_DECODER"):
            _reset_launches()
            records = run_test.main(cfg)
            delta = _read_launches()
        add(delta)
        calls = sum(r["predictor_calls"] for r in records)
        per_call = delta["winograd_conv3d_f23"] // max(calls, 1)
        _require(calls > 0 and per_call > 0, "fused cli: no predictor call "
                 "launched K9")
        _require_launches(f"fused cli ({calls} predictor calls)", delta, {
            **dict.fromkeys(delta, 0), "window_attention": 8 * calls,
            "fused_mlp": 8 * calls, "winograd_conv3d_f23": per_call * calls})
        pred = nifti.load(os.path.join(tmp, "out", "test_output", "Fold0",
                                       "pred", "0.nii.gz")).data
        _require(pred.shape == shape and pred.dtype == np.uint8
                 and int(pred.max()) < 14, "fused cli: prediction file")
        r = records[0]
        print(f"fused: cli MEDSEG_FUSED_DECODER=1 {r['shape']}: "
              f"{r['windows']} windows, {calls} predictor calls, predicted in "
              f"{r['predict_seconds']:.2f} s, K9 launched {per_call} times "
              f"per call", flush=True)
    return total


WINO_TRAIN_STEPS = 3
# one step's gradients with K9 for the forward and dx of every eligible conv
# against the same step through the library's convs, both bf16 with K1-K4:
# Winograd's bf16 rounding (about twice the direct conv's) enters 10 forward
# and 11 input-gradient convs; the same order as bf16 against fp32
TRAIN_WINO_ALT_REL_TOL = 2e-2


def phase_train_wino():
    """Batch 8 with MEDSEG_WINOGRAD_TRAIN=1: K9's training path."""
    import torch

    from medicalsemseg_tpu_torch.train.losses import build_loss

    cfg, model, state, train_step = _train_setup()
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = _train_batch(gen, TRAIN_BATCH, cfg.output_dim)
    loss_fn = build_loss(cfg)
    need = _k9_launches_required(
        model, lambda: _grads_of(model, loss_fn, batch),
        "MEDSEG_WINOGRAD_TRAIN")
    _require(need > 0, "train_wino: the gate opens for no conv")

    def steps(n):
        losses, times = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = train_step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            _require(all(bool(torch.isfinite(v).all()) for v in m.values()),
                     "train_wino: non-finite metrics")
        return losses, times

    with _gates("MEDSEG_WINOGRAD_TRAIN"):
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        losses, times = steps(WINO_TRAIN_STEPS)
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated()
    with _gates():
        _, base_times = steps(2)
    with _gates("MEDSEG_WINOGRAD_TRAIN"):
        _, again = steps(1)
    print(f"train_wino: batch {TRAIN_BATCH} x 96^3, bf16, "
          f"MEDSEG_WINOGRAD_TRAIN=1, {WINO_TRAIN_STEPS} steps: loss "
          f"{' '.join(f'{v:.4f}' for v in losses)}; ms per step "
          f"{' '.join(f'{t:.0f}' for t in times)} (first includes the "
          f"library's choice of algorithms), then unset "
          f"{' '.join(f'{t:.0f}' for t in base_times)}, then set "
          f"{again[0]:.0f}; peak device memory {peak / 2 ** 30:.2f} GiB; K9 "
          f"launched {need} times per step; launches {launches}", flush=True)
    _require(all(b < a for a, b in zip(losses, losses[1:])),
             f"train_wino: the loss did not fall at every step: {losses}")
    _require_launches(f"train_wino ({WINO_TRAIN_STEPS} steps)", launches, {
        **dict.fromkeys(launches, 0),
        **_swin_step_launches(8 * WINO_TRAIN_STEPS),
        "winograd_conv3d_f23": need * WINO_TRAIN_STEPS})
    del state

    with _gates("MEDSEG_WINOGRAD_TRAIN"):
        got_loss, got = _grads_of(model, loss_fn, batch)
    with _gates():
        alt_loss, alt = _grads_of(model, loss_fn, batch)
        want_loss, want, _ = _fp32_plain_grads(
            model, lambda net: _grads_of(net, loss_fn, batch))
    for label, b, b_loss, tol in (
            ("the ungated bf16 step", alt, alt_loss, TRAIN_WINO_ALT_REL_TOL),
            ("fp32 plain", want, want_loss, TRAIN_GRAD_REL_TOL)):
        rel = _rel_norm(got, b)
        print(f"train_wino: gradients of one step (batch {TRAIN_BATCH}), "
              f"bf16 + K9 vs {label}: loss {got_loss:.5f} vs {b_loss:.5f}, "
              f"rel norm err {rel:.3e} (tol {tol})", flush=True)
        _require(rel <= tol, f"train_wino: the gradients with K9 disagree "
                 f"with {label}")
    del model, got, alt, want
    torch.cuda.empty_cache()
    return launches


# (dtype, C, Co, batch, edge) of the conv3d phase's calls of conv3x3x3: the
# full-resolution shapes of the batch-4 path in bf16 (timed), 8 input
# channels in each dtype (K5 on the tensor cores in bf16 only), and the
# fp16 and fp32 forms at batch 1 (timed)
CONV3D_CASES = (("bfloat16", 48, 48, TRAIN_B4_BATCH, CROP),
                ("bfloat16", 96, 48, TRAIN_B4_BATCH, CROP),
                ("bfloat16", 8, 16, 2, 32), ("float16", 8, 16, 2, 32),
                ("float32", 8, 16, 2, 32), ("float16", 48, 48, 1, CROP),
                ("float32", 48, 48, 1, CROP))
# conv3x3x3 in fp32 against the library's fp32 conv without TF32: only the
# order of the fp32 sums differs (K5's weight gradient adds ~10^6 products)
FP32_LIBRARY_REL_TOL = 1e-5


def phase_conv3d():
    """The function conv3x3x3 (K10 forward and dx, K5 for dW) as a user
    calls it, at CONV3D_CASES, against autograd through the library's conv
    (fp32 without TF32); each call must take K10 twice and K5 once, on the
    routes its dtype and channels pick."""
    import torch

    from medicalsemseg_tpu_torch.ops.kernels import conv3d as k10
    from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5

    gen = torch.Generator(device="cuda").manual_seed(10)
    total = dict.fromkeys(_read_launches(), 0)
    for dname, c, co, batch, edge in CONV3D_CASES:
        dt = getattr(torch, dname)
        shape = (batch, edge, edge, edge)
        x = torch.randn(*shape, c, generator=gen,
                        device="cuda").to(dt).requires_grad_(True)
        w = (torch.randn(co, c, 3, 3, 3, generator=gen, device="cuda")
             * (27 * c) ** -0.5).to(dt).requires_grad_(True)
        dy = torch.randn(*shape, co, generator=gen, device="cuda").to(dt)

        def ours():
            y = k10.conv3x3x3(x, w)
            return (y.detach(),) + torch.autograd.grad(y, (x, w), dy)

        def library():
            y = _lib_conv(x, w)
            dx, dw = torch.autograd.grad(y, (x, w), dy.permute(0, 4, 1, 2, 3))
            return y.detach().permute(0, 2, 3, 4, 1), dx, dw

        name = f"conv3d: conv3x3x3 {batch}x{edge}^3, {c}->{co}, {dname}"
        _reset_launches()
        got = ours()
        torch.cuda.synchronize()
        launches = _read_launches()
        _require_launches(name, launches, {
            **dict.fromkeys(launches, 0), "conv3x3x3": 2, "dw27": 1})
        k10_route = k10.conv_route(dt)
        k5_route = ("tensor_core" if dt == torch.bfloat16 and c % 8 == 0
                    and co % 8 == 0 else "cuda_core")
        _require(k10.route_launches[k10_route] == 2
                 and k5.route_launches[k5_route] == 1,
                 f"{name}: K10 {k10.route_launches}, K5 {k5.route_launches}, "
                 f"want K10 2 on {k10_route}, K5 1 on {k5_route}")
        print(f"{name}: K10 {k10.route_launches}, K5 {k5.route_launches}",
              flush=True)
        for k, v in launches.items():
            total[k] += v
        for r, n in k10.route_launches.items():
            ROUTE_TOTALS["conv3x3x3"][r] += n
        tol = FP32_LIBRARY_REL_TOL if dt == torch.float32 else LIBRARY_REL_TOL
        with _no_tf32():
            want = library()
        for what, g, r in zip(("y", "dx", "dw"), got, want):
            _require(g.shape == r.shape and g.dtype == r.dtype,
                     f"{name} {what}: {tuple(g.shape)} {g.dtype}")
            rel = float((g.float() - r.float()).norm() / r.float().norm())
            print(f"{name} {what}: rel norm err vs the library {rel:.3e} "
                  f"(tol {tol})", flush=True)
            _require(rel <= tol, f"{name} {what}: disagrees with the "
                     "library's conv")
        del got, want
        if edge == CROP:
            with _no_tf32():
                t = [_time_ms(fn, 3) for fn in (ours, library, library, ours)]
            print(f"{name}: forward + dx + dW {t[0]:.2f} ms, library "
                  f"{t[1]:.2f}, library {t[2]:.2f}, ours {t[3]:.2f}",
                  flush=True)
        del x, w, dy
        torch.cuda.empty_cache()
    return total


# --compute_dtype float32 with the kernels against float32 with their plain
# versions, on the card, TF32 off on both sides: no rounding differs, only
# the order of fp32 sums inside K1-K5 (a few 1e-7 of each output), carried
# through ~60 layers. Logits: 1e-4 of the norm. One step's gradients: 1e-3,
# since the deep blocks amplify a change of their input about 100-fold at
# seeded weights (PERF.md, on gradients of the deep Swin blocks).
FP32_LOGIT_REL_TOL = 1e-4
FP32_GRAD_REL_TOL = 1e-3
FP32_TRAIN_BATCH = 2      # 1.77M voxels: K5's auto gate opens (fp32 route)
FP32_CLI_SHAPE = (200, 180, 120)
FP16_WINDOWS = 2


class _no_tf32:
    def __enter__(self):
        import torch

        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved


def phase_fp32():
    """``--compute_dtype float32`` through the kernels, as the JAX package
    runs it: the prediction CLI on one volume, two training steps through the
    training CLI at batch 2, one predictor call's logits and one step's
    gradients against the fp32 plain path; then one predictor call with
    ``--compute_dtype float16`` (what ``--mixed_precision`` selects)."""
    import copy

    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.cli import run_test, run_training
    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.data import nifti
    from medicalsemseg_tpu_torch.train.losses import build_loss

    fp32 = ["--compute_dtype", "float32"]
    total = dict.fromkeys(_read_launches(), 0)

    def add(delta):
        for k, v in delta.items():
            total[k] += v

    rng = np.random.default_rng(32)
    with tempfile.TemporaryDirectory() as tmp, _no_tf32():
        # the prediction CLI, then the same volume with the plain versions
        task = os.path.join(tmp, "Task03_SmokeFp32")
        os.makedirs(os.path.join(task, "imagesTs"))
        with open(os.path.join(task, "dataset.json"), "w") as f:
            json.dump({"training": [], "test": ["./imagesTs/img0.nii.gz"]}, f)
        nifti.save(nifti.NiftiImage(_ct_volume(rng, FP32_CLI_SHAPE),
                                    np.diag([0.8, 0.8, 2.5, 1.0])),
                   os.path.join(task, "imagesTs", "img0.nii.gz"))
        preds = []
        for plain in (False, True):
            out_dir = os.path.join(tmp, "out_plain" if plain else "out")
            cfg = get_args(FLAGSHIP_ARGS + fp32 + [
                "--data_path", tmp, "--task", "Task03_SmokeFp32",
                "--output_dir", out_dir, "--device", "cuda"])
            _reset_launches()
            t0 = time.perf_counter()
            if plain:
                with _plain_kernels():
                    records = run_test.main(cfg)
            else:
                records = run_test.main(cfg)
            wall = time.perf_counter() - t0
            delta = _read_launches()
            calls = sum(r["predictor_calls"] for r in records)
            want = {**dict.fromkeys(delta, 0)}
            if not plain:
                want.update({"window_attention": 8 * calls,
                             "fused_mlp": 8 * calls})
                add(delta)
                _check_routes("fp32 cli", "cuda_core")
            _require(calls > 0, "fp32 cli: no predictor call")
            _require_launches(f"fp32 cli ({calls} predictor calls"
                              f"{', plain' if plain else ''})", delta, want)
            pred = nifti.load(os.path.join(out_dir, "test_output", "Fold0",
                                           "pred", "0.nii.gz")).data
            _require(pred.shape == FP32_CLI_SHAPE,
                     f"fp32 cli: pred {pred.shape}")
            preds.append(pred)
            how = "with the plain versions" if plain else "with the kernels"
            print(f"fp32: cli --compute_dtype float32 {how}"
                  f": {calls} predictor calls in {wall:.2f} s, predicted in "
                  f"{records[0]['predict_seconds']:.2f} s", flush=True)
        agree = float((preds[0] == preds[1]).mean())
        print(f"fp32: cli labels, kernels vs plain: {agree:.6f} of voxels "
              "agree", flush=True)
        _require(agree >= 0.999, "fp32 cli: the kernels' labels disagree with "
                 "the plain versions'")

        # two training steps through the CLI at batch 2 (4 training volumes)
        _write_train_set(os.path.join(tmp, "Task04_SmokeTrain32"), 5,
                         (128, 120, 100), 14, rng)
        out = os.path.join(tmp, "out_train")
        os.makedirs(out)
        _reset_launches()
        t0 = time.perf_counter()
        with _dw27_mode(None):
            run_training.main(get_args(TRAIN_ARGS + fp32 + [
                "--n_images_per_batch", str(FP32_TRAIN_BATCH), "--data_path",
                tmp, "--task", "Task04_SmokeTrain32", "--log_dir",
                os.path.join(tmp, "log32"), "--output_dir", out,
                "--t_fixed_ct_intensity", "--t_rand_crop_fgbg",
                "--t_spatial_pad", "--epochs", "1", "--val_interval", "1",
                "--metric_readback_freq", "1"]))
        wall = time.perf_counter() - t0
        delta = _read_launches()
        _check_routes("fp32 train_cli", "cuda_core")
        add(delta)
        with open(os.path.join(out, "log.txt")) as f:
            row = [json.loads(line) for line in f][-1]
        steps = 4 // FP32_TRAIN_BATCH
        _require_launches(f"fp32 train_cli ({steps} steps)", delta, {
            "window_attention_bwd": 8 * steps, "fused_mlp_bwd": 8 * steps,
            "dw27": 3 * steps})
        _require(all(np.isfinite(row[k]) for k in ("train/loss", "val/loss")),
                 f"fp32 train_cli: log row {row}")
        print(f"fp32: run_training --compute_dtype float32, {steps} steps at "
              f"batch {FP32_TRAIN_BATCH} and one validation in {wall:.1f} s, "
              f"loss {row['train/loss']:.4f}, launches "
              f"{ {k: v for k, v in delta.items() if v} }", flush=True)

    # one predictor call's logits and one step's gradients against plain
    cfg = get_args(FLAGSHIP_ARGS + fp32)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = _seeded_model(cfg, gen).to("cuda")
    xb = (torch.randn(FP16_WINDOWS, 96, 96, 96, 1, generator=gen).to("cuda"),
          torch.full((FP16_WINDOWS, 3), 0.5, device="cuda"),
          torch.ones(FP16_WINDOWS, 3, device="cuda"))
    with torch.inference_mode(), _no_tf32():
        _reset_launches()
        got = model(xb)
        torch.cuda.synchronize()
        n1 = _read_launches()["window_attention"]
        _check_routes("fp32 model", "cuda_core")
        with _plain_kernels():
            want = model(xb)
        rel = float((got - want).norm() / want.norm())
        print(f"fp32: one predictor call ({FP16_WINDOWS} windows), kernels vs "
              f"plain: rel norm err {rel:.3e} (tol {FP32_LOGIT_REL_TOL})",
              flush=True)
        _require(n1 == 8 and got.dtype == torch.float32
                 and bool(torch.isfinite(got).all()),
                 f"fp32 model: K1 launched {n1} times, logits {got.dtype}")
        _require(rel <= FP32_LOGIT_REL_TOL, "fp32 model: the kernels' logits "
                 "disagree with the plain versions'")

        # --compute_dtype float16 (the same weights) against the fp32 plain
        # logits: fp16 rounds every activation (2^-11 relative), finer than
        # bf16, so MODEL_REL_TOL holds with room
        half = copy.deepcopy(model)
        half.dtype = torch.float16
        _reset_launches()
        got16 = half(xb)
        torch.cuda.synchronize()
        n16 = _read_launches()
        _check_routes("fp16 model", "tensor_core")
        rel16 = float((got16.float() - want).norm() / want.norm())
        print(f"fp32: one predictor call with --compute_dtype float16 "
              f"({FP16_WINDOWS} windows) vs fp32 plain: rel norm err "
              f"{rel16:.3e} (tol {MODEL_REL_TOL}); launches "
              f"{ {k: v for k, v in n16.items() if v} }", flush=True)
        _require(n16["window_attention"] == 8 and n16["fused_mlp"] == 8
                 and bool(torch.isfinite(got16).all()),
                 "fp16 model: K1/K2 not launched or non-finite logits")
        _require(rel16 <= MODEL_REL_TOL, "fp16 model: logits disagree with "
                 "the fp32 plain path")
        del half, got16, got, want
    del model
    torch.cuda.empty_cache()

    cfg, model, _, _ = _train_setup(fp32 + ["--n_images_per_batch",
                                            str(FP32_TRAIN_BATCH)])
    loss_fn = build_loss(cfg)
    batch = _train_batch(torch.Generator(device="cuda").manual_seed(1),
                         FP32_TRAIN_BATCH, cfg.output_dim)
    with _no_tf32(), _dw27_mode(None):
        _reset_launches()
        got_loss, got = _grads_of(model, loss_fn, batch)
        delta = _read_launches()
        _check_routes("fp32 gradients", "cuda_core")
        with _plain_kernels():
            want_loss, want = _grads_of(model, loss_fn, batch)
    _require_launches("fp32 gradients (one step)", delta, {
        **_swin_step_launches(8), "dw27": 3})
    rel = _rel_norm(got, want)
    print(f"fp32: gradients of one step (batch {FP32_TRAIN_BATCH}), fp32 "
          f"kernels vs fp32 plain: loss {got_loss:.6f} vs {want_loss:.6f}, "
          f"rel norm err {rel:.3e} (tol {FP32_GRAD_REL_TOL})", flush=True)
    _require(rel <= FP32_GRAD_REL_TOL, "fp32: the kernels' gradients disagree "
             "with the plain versions'")
    del model, got, want
    torch.cuda.empty_cache()
    return total


# The shapes of fault F5's paths. K7's CUDA-core route streams K and V in
# key chunks: SegFormer3D at --vol_size 160 has M = 5^3 = 125 reduced tokens
# at every stage (N = 40^3, 20^3, 10^3, 5^3 tokens at C = 48, 96, 192, 384),
# and its stage 4 at --vol_size 192 / 256 N = M = 216 / 512; bf16, batch 16.
# The flagship at --hidden_dim 96 (the f5 phase's training step, batch 2):
# C = 96, 192, 384, 768 over 3, 6, 12, 24 heads (head dim 32), K3 and K4 on
# the CUDA cores at C = 768; K2's CUDA-core route at C = 768 in fp32.
F5_SR_STAGES = tuple((g ** 3, 48 * 2 ** i, 3 * 2 ** i, 125)
                     for i, g in enumerate((40, 20, 10, 5))) + (
    (216, 384, 24, 216), (512, 384, 24, 512))
F5_HIDDEN = 96
F5_TRAIN_BATCH = 2
F5_MLP_C = 768


def _f5_kernels(rep):
    """K7's streaming route, K1-K4 at --hidden_dim 96 and K2's widened
    CUDA-core route at the shapes of fault F5's paths, against their plain
    versions at KERNEL_ATOL (gradients at the swin group's tolerances), a
    rerun bit-equal, timed beside their bounds (stage rows with the paths
    ``vol160`` / ``stream_m{M}``, ``hidden96`` / ``hidden96_train`` and
    ``fp32_c768``; not part of the kernels' sums over the predictor call's
    stages)."""
    import torch

    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
    from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    gen = torch.Generator(device="cuda").manual_seed(15)
    k1, k2 = rep["window_attention"], rep["fused_mlp"]
    k3, k4 = rep["window_attention_bwd"], rep["fused_mlp_bwd"]
    k7 = rep["sr_attention"]
    batch = PREDICT_BATCH
    with torch.inference_mode():
        for n, c, nh, m in F5_SR_STAGES:
            _require(ksr.sr_route(torch.bfloat16, c, nh, m) == "cuda_core",
                     f"K7 N={n}, M={m}: not the CUDA-core route")
            for res, bq in ((False, False), (True, True)):
                x, a = _sr_case(gen, batch, n, c, nh, res, bq)
                a["k"], a["v"] = (torch.randn(batch, m, c, generator=gen,
                                              device="cuda").to(x.dtype)
                                  for _ in range(2))
                want = ksr.sr_attention_plain(x, **a)
                got = ksr.sr_attention(x, **a)
                torch.cuda.synchronize()
                _compare(f"K7 stream {batch}x{n} tokens, M={m}, C={c}, "
                         f"residual {res}, bq {bq}", got, want, k7)
                _require(torch.equal(got, ksr.sr_attention(x, **a)),
                         f"K7 stream N={n}, M={m}: a rerun differs")
                del got, want
            rows = batch * n
            label = "vol160" if m == 125 else f"stream_m{m}"
            _stage_report(
                k7, label, c, batch,
                _time_ms(lambda: ksr.sr_attention(x, **a), 10),
                _time_ms(lambda: ksr.sr_attention_plain(x, **a), 10),
                4 * rows * c * c + 4 * rows * m * c,
                3 * rows * c * 2 + 2 * batch * m * c * 2
                + 2 * c * c * 2 + 2 * c * 4,
                extra={"reference": _sr_reference(x, a)})
            stage = k7["per_stage"][-1]
            stage["N"], stage["M"] = n, m
            stage["device_ms"] = _launch_times(
                lambda: ksr.sr_attention(x, **a), 10,
                (("k7", "sr_attention"),))["k7"]
            print(f"  K7 stream N={n}, M={m}: device time "
                  f"{stage['device_ms']:.4f} ms", flush=True)
            del x, a
            torch.cuda.empty_cache()

        # ---- the flagship at --hidden_dim 96: K1 and K3 at head dim 32
        # (the CUDA-core heads route), K2 and K4 at C = 768, in the
        # training step's forms (batch 2; LN in the kernels, the shortcut
        # inside and outside)
        batch = F5_TRAIN_BATCH
        for grid, c0, nh in STAGES:
            c = c0 * F5_HIDDEN // 48
            for shift, res in ((WS // 2, True), (0, False)):
                wins, a, kw = _attn_case(gen, batch, grid, c, nh, shift, True,
                                         res)
                case = (f"hidden 96 grid {grid}^3 x{batch}, C={c}, nh={nh}, "
                        f"shift {shift}, res {res}")
                got = kwa.window_attention(wins, **a, **kw)
                want = kwa.window_attention_plain(wins, **a, **kw)
                torch.cuda.synchronize()
                _compare("K1 " + case, got, want, k1)
                _require(torch.equal(got, kwa.window_attention(wins, **a,
                                                               **kw)),
                         f"K1 {case}: a rerun differs")
                dy = torch.randn(wins.shape, generator=gen,
                                 device="cuda").to(wins.dtype)
                b = {k: v for k, v in a.items() if k != "bproj"}
                want = kwa.window_attention_bwd_plain(wins, dy=dy, **b, **kw)
                got = kwa.window_attention_bwd(wins, dy=dy, **b, **kw)
                torch.cuda.synchronize()
                _compare_grads("K3 " + case, K3_NAMES, got, want, k3)
                again = kwa.window_attention_bwd(wins, dy=dy, **b, **kw)
                _require(all((u is None and v is None) or torch.equal(u, v)
                             for u, v in zip(got, again)),
                         f"K3 {case}: a rerun differs")
                del got, want, again
            _timed(k1, "window_attention", "hidden96", batch, grid, c, nh,
                   lambda: kwa.window_attention(wins, **a, **kw),
                   lambda: kwa.window_attention_plain(wins, **a, **kw), 5)
            _timed(k3, "window_attention_bwd", "hidden96_train", batch, grid,
                   c, nh,
                   lambda: kwa.window_attention_bwd(wins, dy=dy, **b, **kw),
                   lambda: kwa.window_attention_bwd_plain(wins, dy=dy, **b,
                                                          **kw), 3)
            del wins, a, b, kw, dy
            torch.cuda.empty_cache()

        grid, c = STAGES[-1][0], F5_MLP_C
        for res in (True, False):
            x, a, kw = _mlp_case(gen, batch, grid, c, True, res)
            case = f"hidden 96 grid {grid}^3 x{batch}, C={c}, res {res}"
            got = kmlp.fused_mlp(x, **a, **kw)
            want = kmlp.fused_mlp_plain(x, **a, **kw)
            torch.cuda.synchronize()
            _compare("K2 " + case, got, want, k2)
            _require(torch.equal(got, kmlp.fused_mlp(x, **a, **kw)),
                     f"K2 {case}: a rerun differs")
            dy = torch.randn(x.shape, generator=gen,
                             device="cuda").to(x.dtype)
            b = dict(w1=a["w1"], b1=a["b1"], w2=a["w2"], ln=kw["ln"], dy=dy,
                     residual=res)
            _require(kmlp.mlp_bwd_route(x.dtype, c, 4 * c) == "cuda_core",
                     "K4 C=768: not the CUDA-core route")
            got = kmlp.fused_mlp_bwd(x, **b)
            want = kmlp.fused_mlp_bwd_plain(x, **b)
            torch.cuda.synchronize()
            _compare_grads("K4 cuda_core " + case, K4_NAMES, got, want, k4)
            _require(all(torch.equal(u, v) for u, v in
                         zip(got, kmlp.fused_mlp_bwd(x, **b))),
                     f"K4 {case}: a rerun differs")
            del got, want
        _timed(k2, "fused_mlp", "hidden96", batch, grid, c, STAGES[-1][2],
               lambda: kmlp.fused_mlp(x, **a, **kw),
               lambda: kmlp.fused_mlp_plain(x, **a, **kw), 5,
               extra=_mlp_reference(x, a, kw))
        _timed(k4, "fused_mlp_bwd", "hidden96_train", batch, grid, c,
               STAGES[-1][2], lambda: kmlp.fused_mlp_bwd(x, **b),
               lambda: kmlp.fused_mlp_bwd_plain(x, **b), 3,
               extra=_mlp_reference(x, a, kw, grad=True))
        del x, a, b, kw, dy
        torch.cuda.empty_cache()

        c, batch = F5_MLP_C, PREDICT_BATCH
        x, a, kw = _mlp_case(gen, batch, WS, c, True, True,
                             dtype=torch.float32)
        _require(kmlp.mlp_route(x.dtype, c, c, 4 * c) == "cuda_core",
                 "K2 fp32 C=768: not the CUDA-core route")
        want = kmlp.fused_mlp_plain(x, **a, **kw)
        got = kmlp.fused_mlp(x, **a, **kw)
        torch.cuda.synchronize()
        _compare(f"K2 cuda_core fp32 grid {WS}^3 x{batch}, C={c}, hidden 4C, "
                 "ln+res True", got, want, k2)
        _require(torch.equal(got, kmlp.fused_mlp(x, **a, **kw)),
                 "K2 fp32 C=768: a rerun differs")
        del got, want
        m = x.shape[0]
        _stage_report(
            k2, "fp32_c768", c, batch,
            _time_ms(lambda: kmlp.fused_mlp(x, **a, **kw), 5),
            _time_ms(lambda: kmlp.fused_mlp_plain(x, **a, **kw), 5),
            16 * m * c * c, 2 * m * c * 4 + 8 * c * c * 4 + 5 * c * 4
            + 2 * c * 4, PEAK_FP32_FLOPS,
            extra=_mlp_reference(x, a, kw))
        del x, a, kw
        torch.cuda.empty_cache()


# --num_heads 1 2 4 8 at --hidden_dim 48 and 96: head dims 48 and 96 at every
# stage (ROADMAP R15), the wide forms of K1, K3 and K6 and K7's CUDA-core
# route; batch 2 (one training step's crops, the windows of two predictor
# windows), in bf16 and fp32. SegFormer3D's stages at vol 96 (M = 27) and
# vol 160 (M = 125) for K7.
R15_HEADS = (1, 2, 4, 8)
R15_HIDDEN = (48, 96)
R15_BATCH = 2
# K1 at the windows of MONAI's blocks (SwinUNETR_Official under
# MEDSEG_OFFICIAL_FUSED=1): the constructor window 7^3, its shift 3^3
OFFICIAL_WINDOW = (7, 7, 7)


def _official_attn_case(gen, batch, dims, ws, shift, c, nh, ln):
    """K1's inputs on the windows of a (batch, *dims, C) bf16 volume that
    is a multiple of the per-axis window ``ws``; with ``ln`` the LayerNorm
    rows and the shortcut inside (the absorbed route)."""
    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.ops import window as tw

    dev, bf = "cuda", torch.bfloat16
    n = int(np.prod(ws))
    x = torch.randn(batch, *dims, c, generator=gen, device=dev).to(bf)
    wins = tw.window_partition(x, ws).contiguous()
    s = c ** -0.5
    args = dict(
        wqkv=(torch.randn(3 * c, c, generator=gen, device=dev) * s).to(bf),
        bqkv=torch.randn(3 * c, generator=gen, device=dev) * 0.1,
        wproj=(torch.randn(c, c, generator=gen, device=dev) * s).to(bf),
        bproj=torch.randn(c, generator=gen, device=dev) * 0.1,
        bias=torch.randn(nh, n, n, generator=gen, device=dev) * 0.5)
    kw = dict(grid_dims=tuple(d // w for d, w in zip(dims, ws)), window=ws,
              shift=tuple(shift), residual=ln,
              ln=(torch.stack([1 + 0.3 * torch.randn(c, generator=gen,
                                                     device=dev),
                               0.1 * torch.randn(c, generator=gen,
                                                 device=dev)])
                  if ln else None))
    return wins, args, kw


def _official_kernels(report):
    """K1 against its plain version at SwinUNETR_Official's four stages of
    one predictor call (batch 16) with the gate on: stages 1-3 pad their
    grids 48, 24, 12 to 49, 28, 14 and take 7^3 = 343-token windows (the
    CUDA-core heads route: over the tensor-core route's 224 tokens), no
    LayerNorm inside; stage 4 clamps the window to the 6^3 grid with no
    shift (the tensor-core route, LayerNorm and shortcut inside). Each stage
    unshifted and shifted; the unshifted one timed beside its plain version,
    its bound and SDPA on the same q, k, v (a reference point). Then the
    clamped anisotropic window of the JAX tests' third case (grid (2, 4, 4)
    under window (4, 2, 2): window (2, 2, 2), shift (0, 1, 1)) on both
    routes."""
    import torch

    from medicalsemseg_tpu_torch.ops import window as tw
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    gen = torch.Generator(device="cuda").manual_seed(14)
    half = tuple(w // 2 for w in OFFICIAL_WINDOW)
    for grid, c, nh in STAGES:
        ws, ss = tw.resolve_window_official((grid,) * 3, OFFICIAL_WINDOW, half)
        dims = tuple(-(-grid // w) * w for w in ws)
        ln = dims == (grid,) * 3
        n = ws[0] * ws[1] * ws[2]
        route = kwa.attention_route(torch.bfloat16, n, c // nh)
        shifts = [(0, 0, 0)] + ([ss] if any(ss) else [])
        for shift in shifts:
            wins, a, kw = _official_attn_case(gen, PREDICT_BATCH, dims, ws,
                                              shift, c, nh, ln)
            label = (f"K1 official grid {grid}^3 (padded to {dims}), window "
                     f"{ws}, shift {shift}, {route}")
            _compare(label, kwa.window_attention(wins, **a, **kw),
                     kwa.window_attention_plain(wins, **a, **kw), report)
            if shift == (0, 0, 0):
                t = wins.shape[0]
                ms = _time_ms(lambda: kwa.window_attention(wins, **a, **kw), 5)
                pms = _time_ms(lambda: kwa.window_attention_plain(
                    wins, **a, **kw), 3)
                flops, nbytes = _work("window_attention", t, n, c, nh)
                _stage_report(report, f"official predict {n} tokens "
                              f"{route}", c, PREDICT_BATCH, ms, pms, flops,
                              nbytes, extra=_sdpa_reference(wins, a, kw))
                report["per_stage"][-1].update(tokens=n, route=route)
            del wins, a, kw
            torch.cuda.empty_cache()
    ws, ss = tw.resolve_window_official((2, 4, 4), (4, 2, 2), (2, 1, 1))
    _require((ws, ss) == ((2, 2, 2), (0, 1, 1)),
             f"official clamp: {(ws, ss)}")
    wins, a, kw = _official_attn_case(gen, PREDICT_BATCH, (2, 4, 4), ws, ss,
                                      48, 3, True)
    for route in kwa.ROUTES:
        _compare(f"K1 official clamped grid (2, 4, 4) under window (4, 2, "
                 f"2): window {ws}, shift {ss}, {route}",
                 kwa.window_attention(wins, **a, **kw, route=route),
                 kwa.window_attention_plain(wins, **a, **kw), report)


R15_SR_VOLS = ((96, (24, 12, 6, 3), 27), (160, (40, 20, 10, 5), 125))


def _r15_kernels(rep):
    """K1, K3 (every output), K6 and K7 at head dims 48 and 96 against their
    plain versions (bf16: KERNEL_ATOL and the swin group's gradient
    tolerances; fp32: FP32_KERNEL_TOL and its gradient tolerances), a rerun
    bit-equal, timed beside their bounds and SDPA (stage rows with the paths
    ``r15_h{hidden}[_fp32]``, K7's ``r15_h{hidden}_vol{96,160}[_fp32]``)."""
    import torch

    from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
    from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    gen = torch.Generator(device="cuda").manual_seed(12)
    k1, k3 = rep["window_attention"], rep["window_attention_bwd"]
    k6, k7 = rep["global_window_attention"], rep["sr_attention"]
    batch, n = R15_BATCH, WS ** 3
    with torch.inference_mode():
        for dt, hidden in [(d, h) for d in (torch.bfloat16, torch.float32)
                           for h in R15_HIDDEN]:
            fp32 = dt == torch.float32
            tol = FP32_KERNEL_TOL if fp32 else KERNEL_ATOL
            gtol = ((FP32_GRAD_NORM_TOL, FP32_GRAD_MAX_TOL) if fp32
                    else (None, None))
            timed = dict(elem=4, peak=PEAK_FP32_FLOPS) if fp32 else {}
            path = f"r15_h{hidden}" + ("_fp32" if fp32 else "")
            tag = "fp32" if fp32 else "bf16"
            elem = 4 if fp32 else 2
            for i, ((grid, c0, _), nh) in enumerate(zip(STAGES, R15_HEADS)):
                c = c0 * hidden // 48
                hd = c // nh
                _require(kwa.attention_route(dt, n, hd) == "cuda_core"
                         and ksr.sr_route(dt, c, nh, 27) == "cuda_core",
                         f"r15: head dim {hd} not on the CUDA-core routes")
                for shift, res in ((WS // 2, True), (0, False)):
                    wins, a, kw = _attn_case(gen, batch, grid, c, nh, shift,
                                             True, res, dt)
                    case = (f"{tag} hidden {hidden} grid {grid}^3 x{batch}, "
                            f"C={c}, head dim {hd}, shift {shift}, res {res}")
                    got = kwa.window_attention(wins, **a, **kw)
                    want = kwa.window_attention_plain(wins, **a, **kw)
                    torch.cuda.synchronize()
                    _compare("K1 " + case, got, want, k1, tol)
                    _require(torch.equal(got, kwa.window_attention(
                        wins, **a, **kw)), f"K1 {case}: a rerun differs")
                    dy = torch.randn(wins.shape, generator=gen,
                                     device="cuda").to(dt)
                    b = {k: v for k, v in a.items() if k != "bproj"}
                    want = kwa.window_attention_bwd_plain(wins, dy=dy, **b,
                                                          **kw)
                    got = kwa.window_attention_bwd(wins, dy=dy, **b, **kw)
                    torch.cuda.synchronize()
                    _compare_grads("K3 " + case, K3_NAMES, got, want, k3,
                                   *gtol)
                    again = kwa.window_attention_bwd(wins, dy=dy, **b, **kw)
                    _require(all((u is None and v is None)
                                 or torch.equal(u, v)
                                 for u, v in zip(got, again)),
                             f"K3 {case}: a rerun differs")
                    del got, want, again
                # the unshifted form is timed, beside SDPA on its q, k, v
                _timed(k1, "window_attention", path, batch, grid, c, nh,
                       lambda: kwa.window_attention(wins, **a, **kw),
                       lambda: kwa.window_attention_plain(wins, **a, **kw), 3,
                       extra=_sdpa_reference(wins, a, kw), **timed)
                _timed(k3, "window_attention_bwd", path, batch, grid, c, nh,
                       lambda: kwa.window_attention_bwd(wins, dy=dy, **b,
                                                        **kw),
                       lambda: kwa.window_attention_bwd_plain(
                           wins, dy=dy, **b, **kw), 3,
                       extra=_sdpa_reference(wins, a, kw, grad=True), **timed)
                del wins, a, b, kw, dy
                torch.cuda.empty_cache()

                wins, a, kw = _global_case(gen, batch, grid, c, nh, True,
                                           False, dt)
                case = (f"{tag} hidden {hidden} grid {grid}^3 x{batch}, "
                        f"C={c}, head dim {hd}")
                got = kga.global_window_attention(wins, **a, **kw)
                want = kga.global_window_attention_plain(wins, **a, **kw)
                torch.cuda.synchronize()
                _compare("K6 " + case, got, want, k6, tol)
                _require(torch.equal(got, kga.global_window_attention(
                    wins, **a, **kw)), f"K6 {case}: a rerun differs")
                del got, want
                t = wins.shape[0]
                m = t * n
                _stage_report(
                    k6, path, c, batch,
                    _time_ms(lambda: kga.global_window_attention(
                        wins, **a, **kw), 3),
                    _time_ms(lambda: kga.global_window_attention_plain(
                        wins, **a, **kw), 3),
                    6 * m * c * c + 4 * t * n * n * c,
                    2 * m * c * elem + batch * n * c * elem
                    + 3 * c * c * elem + 5 * c * 4 + nh * n * n * 4,
                    timed.get("peak"),
                    extra=_sdpa_global_reference(wins, a, kw))
                del wins, a, kw
                torch.cuda.empty_cache()

                for vol, grids, m_keys in R15_SR_VOLS:
                    ntok = grids[i] ** 3
                    x, a = _sr_case(gen, batch, ntok, c, nh, True, True, dt)
                    a["k"], a["v"] = (torch.randn(batch, m_keys, c,
                                                  generator=gen,
                                                  device="cuda").to(dt)
                                      for _ in range(2))
                    case = (f"{tag} hidden {hidden} vol {vol}, {batch}x{ntok} "
                            f"tokens, M={m_keys}, C={c}, head dim {hd}")
                    got = ksr.sr_attention(x, **a)
                    want = ksr.sr_attention_plain(x, **a)
                    torch.cuda.synchronize()
                    _compare("K7 " + case, got, want, k7, tol)
                    _require(torch.equal(got, ksr.sr_attention(x, **a)),
                             f"K7 {case}: a rerun differs")
                    del got, want
                    rows = batch * ntok
                    _stage_report(
                        k7, f"r15_h{hidden}_vol{vol}"
                        + ("_fp32" if fp32 else ""), c, batch,
                        _time_ms(lambda: ksr.sr_attention(x, **a), 5),
                        _time_ms(lambda: ksr.sr_attention_plain(x, **a), 5),
                        4 * rows * c * c + 4 * rows * m_keys * c,
                        3 * rows * c * elem + 2 * batch * m_keys * c * elem
                        + 2 * c * c * elem + 2 * c * 4, timed.get("peak"),
                        extra={"reference": _sr_reference(x, a)})
                    stage = k7["per_stage"][-1]
                    stage["N"], stage["M"] = ntok, m_keys
                    del x, a
                    torch.cuda.empty_cache()


EVAL_SHAPES = ((240, 240, 140), (200, 180, 120))
EVAL_ORGANS = 13     # label classes 1-13 are seeded blobs (BTCV's organs)
EVAL_HOST_CLASSES = 3  # the organ classes whose HD95 the host also computes


def _label_volume(rng, shape):
    """A label map of seeded ellipsoid blobs, classes 1 .. EVAL_ORGANS, over
    background: organ-sized surfaces for HD95."""
    import numpy as np

    grids = np.meshgrid(*[np.linspace(-1, 1, s, dtype=np.float32)
                          for s in shape], indexing="ij")
    lab = np.zeros(shape, np.uint8)
    for c in range(1, EVAL_ORGANS + 1):
        center = rng.uniform(-0.5, 0.5, 3)
        radii = rng.uniform(0.12, 0.3, 3)
        inside = sum(((g - x0) / r) ** 2
                     for g, x0, r in zip(grids, center, radii)) < 1
        lab[inside] = c
    return lab


def phase_eval():
    """The labelled evaluation CLI at full width: two synthetic CT volumes
    with 14 classes with --device_hd95, 8 K1 and 8 K2 launches per
    predictor call; host HD95 of organ classes 1-3 of the smaller volume's
    saved prediction, bit-equal to the CLI's device HD95 (a class's HD95
    reads its own masks alone, so three classes hold the host path as well
    as thirteen, in a tenth of the host's time); then the fold majority-vote
    CLI over three fold directories of the smaller volume, held against
    majority_vote_np."""
    import shutil

    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.cli import majority_vote, run_evaluation
    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.data import nifti
    from medicalsemseg_tpu_torch.infer.ensemble import majority_vote_np
    from medicalsemseg_tpu_torch.train.metrics import hausdorff95

    rng = np.random.default_rng(3)
    task = "Task03_SmokeEval"
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        for sub in ("imagesTr", "labelsTr"):
            os.makedirs(os.path.join(tmp, task, sub))
        val = []
        for i, shape in enumerate(EVAL_SHAPES):
            aff = np.diag([0.8, 0.8, 2.5, 1.0])
            aff[:3, 3] = (-96.0, 20.0, 31.0)
            name = f"img{i}.nii.gz"
            nifti.save(nifti.NiftiImage(_ct_volume(rng, shape), aff),
                       os.path.join(tmp, task, "imagesTr", name))
            nifti.save(nifti.NiftiImage(_label_volume(rng, shape), aff),
                       os.path.join(tmp, task, "labelsTr", name))
            val.append({"image": f"./imagesTr/{name}",
                        "label": f"./labelsTr/{name}"})
        with open(os.path.join(tmp, task, "dataset.json"), "w") as f:
            json.dump({"training": [], "validation": val}, f)

        results = {}
        for label, extra, t, ids in (("device", ["--device_hd95"], task,
                                      (0, 1)),):
            out_dir = os.path.join(tmp, "out_" + label)
            cfg = get_args(FLAGSHIP_ARGS + extra + [
                "--data_path", tmp, "--task", t, "--output_dir", out_dir,
                "--device", "cuda"])
            _reset_launches()
            t0 = time.perf_counter()
            res = run_evaluation.main(cfg)
            wall = time.perf_counter() - t0
            delta = _read_launches()
            _check_routes(f"eval {label}", "tensor_core")
            for k, v in delta.items():
                total[k] = total.get(k, 0) + v
            calls = sum(r["predictor_calls"] for r in res["records"])
            _require(len(res["records"]) == len(ids) and calls > 0,
                     f"eval {label}: {len(res['records'])} volumes, {calls} "
                     "predictor calls")
            _require_launches(f"eval {label} ({calls} predictor calls)",
                              delta, {**dict.fromkeys(delta, 0),
                                      "window_attention": 8 * calls,
                                      "fused_mlp": 8 * calls})
            for r in res["records"]:
                print(f"eval: {label} HD95 {r['name']} {r['shape']}: "
                      f"{r['windows']} windows, {r['predictor_calls']} "
                      f"predictor calls, predict_seconds "
                      f"{r['predict_seconds']:.3f}, hd95_seconds "
                      f"{r['hd95_seconds']:.3f}, seconds {r['seconds']:.3f}",
                      flush=True)
            print(f"eval: {label} HD95: mDice {res['mDice']:.4f}, mHD95 "
                  f"{res['mHD95']:.3f}, {wall:.2f} s for {len(ids)} volumes",
                  flush=True)
            for i, r in zip(ids, res["records"]):
                for sub in ("pred", "img", "gt"):
                    path = os.path.join(out_dir, "eval_output", "Fold0", sub,
                                        f"img{i}.nii.gz")
                    _require(os.path.exists(path), f"eval {label}: no {path}")
                    _require(nifti.load(path).data.shape == r["shape"],
                             f"eval {label}: {sub} {i} is not {r['shape']}")
            results[label] = res, out_dir

        dev, dev_dir = results["device"]

        def saved(out_dir, sub, i):
            return nifti.load(os.path.join(out_dir, "eval_output", "Fold0",
                                           sub, f"img{i}.nii.gz")).data

        # a class's HD95 reads its own masks alone: the other classes set to
        # background leave classes 1-3's as they are
        keep = np.arange(1, EVAL_HOST_CLASSES + 1)
        pred, gt = saved(dev_dir, "pred", 1), saved(dev_dir, "gt", 1)
        t0 = time.perf_counter()
        want = hausdorff95(np.where(np.isin(pred, keep), pred, 0),
                           np.where(np.isin(gt, keep), gt, 0),
                           EVAL_HOST_CLASSES + 1)
        host_s = time.perf_counter() - t0
        print(f"eval: host HD95 of classes 1-{EVAL_HOST_CLASSES} of the "
              f"smaller volume in {host_s:.2f} s: "
              f"{np.round(want, 3).tolist()}", flush=True)
        _require(np.array_equal(dev["hd95"][1, :EVAL_HOST_CLASSES], want,
                                equal_nan=True),
                 "eval: device HD95 is not bit-equal to host HD95")
        _require(np.isfinite(dev["hd95"][:, :EVAL_ORGANS]).any()
                 and np.isfinite(want).any(),
                 "eval: no organ has a finite HD95")

        # the vote over the smaller volume's prediction alone: each fold's
        # copy of the larger one cost a gzip NIfTI write of seconds
        folds = os.path.join(tmp, "folds")
        preds = ["img1.nii.gz"]
        stacks = {}
        for k in range(3):
            d = os.path.join(folds, f"Fold{k}", "pred")
            os.makedirs(d)
            for name in preds:
                img = nifti.load(os.path.join(dev_dir, "eval_output",
                                              "Fold0", "pred", name))
                data = np.array(img.data)
                if k:   # folds 1 and 2 claim class 3 in nested blocks
                    data[20:60 + 40 * (k == 2), 30:90, 10:40] = 3
                nifti.save(nifti.NiftiImage(data, img.affine),
                           os.path.join(d, name))
                stacks.setdefault(name, []).append(data.astype(np.int64))
        t0 = time.perf_counter()
        majority_vote.main(majority_vote.get_args([
            "--in_folder", folds, "--n_classes", "14", "--folds", "3"]))
        vote_s = time.perf_counter() - t0
        for name in preds:
            got = nifti.load(os.path.join(folds, "majority_vote", name)).data
            want_vote = majority_vote_np(np.stack(stacks[name]), 14)
            _require(got.dtype == np.uint8
                     and np.array_equal(got, want_vote.astype(np.uint8)),
                     f"eval: majority vote of {name} disagrees")
        print(f"eval: majority vote over 3 folds of 1 volume in "
              f"{vote_s:.2f} s agrees with majority_vote_np", flush=True)
        shutil.rmtree(folds)
    return total


F5_SEG_VOL = 160     # SegFormer3D: M = 5^3 = 125 reduced tokens at each stage


def phase_f5():
    """Fault F5's shapes through the entry points a user calls: SegFormer3D
    at --vol_size 160 through the predictor (K7 on its streaming CUDA-core
    route in all 8 blocks; logits against the fp32 plain path at the zoo
    phase's tolerance; one predictor call timed), and one flagship training
    step at --hidden_dim 96, batch 2 (K1-K4 in all 8 blocks, K3 and K4 on
    their CUDA-core routes at stage 4, C = 768; gradients against the fp32
    plain path at the train phase's tolerance)."""
    import copy

    import torch

    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.train.losses import build_loss

    total = {}

    def add(delta):
        for k, v in delta.items():
            total[k] = total.get(k, 0) + v

    args = _zoo_args("SegFormer3D")
    args[args.index("--vol_size") + 1] = str(F5_SEG_VOL)
    cfg = get_args(args)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = _seeded_model(cfg, gen).to("cuda")
    ref = copy.deepcopy(model)
    ref.dtype = torch.float32
    v = F5_SEG_VOL
    vol = torch.randn(1, v, v, v, 1, generator=gen).to("cuda")
    x_in = (vol, torch.full((1, 3), 0.5, device="cuda"),
            torch.ones(1, 3, device="cuda"))
    with torch.inference_mode():
        _reset_launches()
        got = model(x_in)
        torch.cuda.synchronize()
        launches = _read_launches()
        routes = _add_routes("f5 SegFormer3D vol 160")
        add(launches)
        _require(routes["sr_attention"]["cuda_core"] == 8
                 and routes["sr_attention"]["tensor_core"] == 0,
                 f"f5: SegFormer3D at vol {v}: K7 by route "
                 f"{routes['sr_attention']} (want 8 on the CUDA cores)")
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            with _plain_kernels():
                want = ref(x_in)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        del ref
        _require(got.shape == (1, v, v, v, 14)
                 and bool(torch.isfinite(got).all()),
                 f"f5: SegFormer3D logits {tuple(got.shape)}")
        rel = float((got - want).norm() / want.norm())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        print(f"f5: SegFormer3D {v}^3, bf16+kernels vs fp32 plain (card, "
              f"TF32 off): rel norm err {rel:.3e} (tol {MODEL_REL_TOL}), "
              f"argmax agreement {agree:.4f}", flush=True)
        _require(rel <= MODEL_REL_TOL, "f5: SegFormer3D's bf16 logits "
                 "disagree with the fp32 plain path")
        del got, want
        xb = tuple(torch.cat([t] * PREDICT_BATCH) for t in x_in)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        out = model(xb)
        torch.cuda.synchronize()
        add(_read_launches())
        _check_routes("f5 SegFormer3D predictor call", "cuda_core")
        peak = torch.cuda.max_memory_allocated()
        _require(out.shape == (PREDICT_BATCH, v, v, v, 14)
                 and bool(torch.isfinite(out).all()),
                 "f5: SegFormer3D predictor call")
        del out

        def call_ms(plain):
            if plain:
                with _plain_kernels():
                    return _time_ms(lambda: model(xb), 2)
            return _time_ms(lambda: model(xb), 2)

        ms = [call_ms(plain) for plain in (False, True, True, False)]
        print(f"f5: SegFormer3D one predictor call ({PREDICT_BATCH} windows "
              f"of {v}^3): kernels {ms[0]:.1f} ms, plain {ms[1]:.1f}, plain "
              f"{ms[2]:.1f}, kernels {ms[3]:.1f}; peak device memory "
              f"{peak / 2 ** 30:.2f} GiB", flush=True)
    del model, xb, x_in
    torch.cuda.empty_cache()

    cfg, model, state, train_step = _train_setup(["--hidden_dim", "96"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = _train_batch(gen, F5_TRAIN_BATCH, cfg.output_dim)
    times = []
    for step in range(3):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            m = train_step(state, batch)
        except torch.cuda.OutOfMemoryError:
            raise PhaseError(
                f"zoo_train {name}: batch {batch_size} no longer fits the "
                "card's memory (peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
                "when it ran out)") from None
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _require(all(bool(torch.isfinite(u).all()) for u in m.values()),
                 f"f5: non-finite metrics at step {step}")
        launches = _read_launches()
        routes = _add_routes(f"f5 hidden 96 step {step}")
        add(launches)
    # every block on the kernels (head dim 32: the CUDA-core heads route);
    # stage 4 (C = 768): K3's GEMM launches and K4 on the CUDA cores
    _require_launches("f5 hidden 96 (one step)", launches,
                      _swin_step_launches(8))
    _require(routes["fused_mlp_bwd"]["cuda_core"] == 2
             and routes["window_attention_bwd_gemm"]["cuda_core"] == 2,
             f"f5: stage 4's backward by route {routes['fused_mlp_bwd']}, "
             f"{routes['window_attention_bwd_gemm']} (want 2 on the CUDA "
             "cores)")
    print(f"f5: hidden 96, batch {F5_TRAIN_BATCH} x 96^3, bf16: ms per step "
          f"{' '.join(f'{t:.0f}' for t in times)} (the first includes "
          f"cuDNN's choice of algorithms); loss {float(m['loss']):.4f}; "
          f"launches {launches}", flush=True)
    del state, m
    loss_fn = build_loss(cfg)

    def grads_of(net):
        return _grads_of(net, loss_fn, batch)

    got_loss, got = grads_of(model)
    want_loss, want, _ = _fp32_plain_grads(model, grads_of)
    rel = _rel_norm(got, want)
    print(f"f5: hidden 96 gradients of one step (batch {F5_TRAIN_BATCH}), "
          f"bf16+kernels vs fp32 plain: loss {got_loss:.5f} vs "
          f"{want_loss:.5f}, rel norm err {rel:.3e} (tol "
          f"{TRAIN_GRAD_REL_TOL})", flush=True)
    _require(rel <= TRAIN_GRAD_REL_TOL, "f5: the hidden-96 gradients "
             "disagree with the fp32 plain path")
    del model, got, want
    torch.cuda.empty_cache()
    return total


R15_ARGS = ["--num_heads"] + [str(h) for h in R15_HEADS]
# per predictor call at heads 1 2 4 8: each attention launch on the wide
# CUDA-core heads form
R15_CALL_LAUNCHES = {
    "nnFormerUNETR": {"window_attention": 8, "fused_mlp": 8},
    "GCViTUNETR": {"window_attention": 4, "global_window_attention": 4,
                   "fused_mlp": 8},
    "SegFormer3D": {"sr_attention": 8},
}


def _call_vs_plain(phase, args, want_launches):
    """One window of ``args``'s model in bf16 with the kernels against the
    same weights in fp32 with the plain versions on the card (TF32 off), at
    MODEL_REL_TOL; then one predictor call of PREDICT_BATCH windows with its
    launches and routes (the heads launches on the CUDA cores) and its time.
    Returns the call's launches."""
    import copy

    import torch

    from medicalsemseg_tpu_torch.config import get_args

    cfg = get_args(args)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = _seeded_model(cfg, gen).to("cuda")
    ref = copy.deepcopy(model)
    ref.dtype = torch.float32
    vol = torch.randn(1, 96, 96, 96, 1, generator=gen).to("cuda")
    x_in = (vol, torch.full((1, 3), 0.5, device="cuda"),
            torch.ones(1, 3, device="cuda"))
    with torch.inference_mode():
        got = model(x_in)
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            with _plain_kernels():
                want = ref(x_in)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        del ref
        _require(got.shape == (1, 96, 96, 96, 14)
                 and bool(torch.isfinite(got).all()),
                 f"{phase}: logits {tuple(got.shape)}")
        rel = float((got - want).norm() / want.norm())
        print(f"{phase}: 96^3, bf16+kernels vs fp32 plain (card, TF32 off): "
              f"rel norm err {rel:.3e} (tol {MODEL_REL_TOL})", flush=True)
        _require(rel <= MODEL_REL_TOL, f"{phase}: bf16 logits disagree with "
                 "the fp32 plain path")
        del got, want
        xb = tuple(torch.cat([t] * PREDICT_BATCH) for t in x_in)
        torch.cuda.empty_cache()
        _reset_launches()
        out = model(xb)
        torch.cuda.synchronize()
        launches = _read_launches()
        routes = _add_routes(phase)
        _require(out.shape == (PREDICT_BATCH, 96, 96, 96, 14)
                 and bool(torch.isfinite(out).all()),
                 f"{phase}: logits of {PREDICT_BATCH} windows")
        del out
        _require_launches(f"{phase} (one predictor call)", launches,
                          {**dict.fromkeys(launches, 0), **want_launches})
        for name in ("window_attention", "global_window_attention",
                     "sr_attention"):
            _require(routes[name]["tensor_core"] == 0,
                     f"{phase}: {name} by route {routes[name]} (head dim 48: "
                     "the CUDA cores)")
        ms = _time_ms(lambda: model(xb), 2)
        print(f"{phase}: one predictor call ({PREDICT_BATCH} windows): "
              f"{ms:.1f} ms; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    del model, xb, x_in
    torch.cuda.empty_cache()
    return launches


def phase_r15():
    """--num_heads 1 2 4 8 at --hidden_dim 48 (head dim 48 at every stage)
    through the entry points a user calls: one flagship predictor call and
    one training step at batch 2 (K1-K4 in all 8 blocks, K1's and K3's heads
    launches on their wide CUDA-core form; gradients against the fp32 plain
    path at TRAIN_GRAD_REL_TOL), then one GCViTUNETR and one SegFormer3D
    predictor call (K1 / K6 and K7 on the CUDA cores)."""
    import torch

    from medicalsemseg_tpu_torch.train.losses import build_loss

    total = {}

    def add(delta):
        for k, v in delta.items():
            total[k] = total.get(k, 0) + v

    add(_call_vs_plain("r15 nnFormerUNETR", FLAGSHIP_ARGS + R15_ARGS,
                       R15_CALL_LAUNCHES["nnFormerUNETR"]))

    cfg, model, state, train_step = _train_setup(R15_ARGS)
    gen = torch.Generator(device="cuda").manual_seed(12)
    batch = _train_batch(gen, R15_BATCH, cfg.output_dim)
    times = []
    for step in range(2):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            m = train_step(state, batch)
        except torch.cuda.OutOfMemoryError:
            raise PhaseError(
                f"zoo_train {name}: batch {batch_size} no longer fits the "
                "card's memory (peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
                "when it ran out)") from None
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _require(all(bool(torch.isfinite(u).all()) for u in m.values()),
                 f"r15: non-finite metrics at step {step}")
        launches = _read_launches()
        routes = _add_routes(f"r15 training step {step}")
        add(launches)
    _require_launches("r15 training step", launches,
                      _swin_step_launches(8))
    _require(routes["window_attention"] == {
        "tensor_core": 0, "cuda_core": REMAT_FORWARDS * 8}
             and routes["window_attention_bwd"] == {"tensor_core": 0,
                                                    "cuda_core": 8},
             f"r15: the heads launches by route {routes['window_attention']},"
             f" {routes['window_attention_bwd']} (want {REMAT_FORWARDS} x 8 "
             "and 8 on the CUDA cores)")
    print(f"r15: heads 1 2 4 8, batch {R15_BATCH} x 96^3, bf16: ms per step "
          f"{' '.join(f'{t:.0f}' for t in times)}; loss "
          f"{float(m['loss']):.4f}; launches {launches}", flush=True)
    del state, m
    loss_fn = build_loss(cfg)

    def grads_of(net):
        return _grads_of(net, loss_fn, batch)

    got_loss, got = grads_of(model)
    want_loss, want, _ = _fp32_plain_grads(model, grads_of)
    rel = _rel_norm(got, want)
    print(f"r15: gradients of one step (batch {R15_BATCH}), bf16+kernels vs "
          f"fp32 plain: loss {got_loss:.5f} vs {want_loss:.5f}, rel norm err "
          f"{rel:.3e} (tol {TRAIN_GRAD_REL_TOL})", flush=True)
    _require(rel <= TRAIN_GRAD_REL_TOL, "r15: the gradients disagree with "
             "the fp32 plain path")
    del model, got, want
    torch.cuda.empty_cache()

    for name in ("GCViTUNETR", "SegFormer3D"):
        args = _zoo_args(name)
        args = args[:args.index("--num_heads")] + R15_ARGS
        add(_call_vs_plain(f"r15 {name}", args, R15_CALL_LAUNCHES[name]))
    return total


# Training of the three zoo models at full default width (hidden 48, depths
# 2 2 2 2, heads 3 6 12 24, 96^3 crops, bf16). Kernel launches of one
# training step: GC-ViT runs K1 forward and K3 backward in its 4 local
# blocks (its 4 global blocks have no backward kernel and run the module's
# unfused attention) and K2 / K4 in all 8 MLPs; SwinSegFormer runs K1-K4 in
# its 8 Swin blocks; SegFormer3D runs none of them (K7 has no backward
# kernel); SwInception and SwinDepth run K1 / K3 in their 8 blocks and no K2
# / K4 (their inception and depthwise MLPs have no kernel), and K1 twice a
# block (REMAT_FORWARDS: the JAX factory gives --remat to their Swin
# encoder, not to GC-ViT's, SwinSegFormer's or nnFormer's); K5 and K8 stay
# off at batch 8 (K5's gate window ends at 4M voxels; the loss is the
# unfused one).
ZOO_TRAIN_LAUNCHES = {
    "GCViTUNETR": {"window_attention": 4, "window_attention_bwd": 4,
                   "fused_mlp": 8, "fused_mlp_bwd": 8},
    "SegFormer3D": {},
    "SwinSegFormer": dict.fromkeys(SWIN_KERNELS, 8),
    "SwInception": _swin_step_launches(8, ("window_attention",
                                           "window_attention_bwd")),
    "SwinDepth": _swin_step_launches(8, ("window_attention",
                                         "window_attention_bwd")),
    # the official nnFormer: K1 / K3 in its 11 Swin blocks, K2 / K4 in
    # their MLPs and the 3 cross blocks'; the MONAI blocks train plain
    "nnFormer": {"window_attention": 11, "window_attention_bwd": 11,
                 "fused_mlp": 14, "fused_mlp_bwd": 14},
    "VideoSwinUNETR": {},
    "SwinUNETR_Official": {},
    # FocalNet's and ViT's MLPs train plain, as in JAX; LRGFormer has no
    # kernel of its own, but batch 8 of 64^3 (2.1M voxels) lies in K5's auto
    # window, so the decoder's three full-resolution convs take K5 for their
    # weight gradient, as in JAX
    "FocalNetUNETR": {}, "UNETR_Official": {},
    "LRGFormerUNETR": {"dw27": 3},
}
ZOO_TRAIN_STEPS = 4
# crops a step: all three models fit the card at batch 8 (PERF.md, PR 12),
# so a batch that no longer fits fails the phase
ZOO_TRAIN_BATCH = 8
ZOO_GRAD_BATCH = 2
# batches of the whole-gradient check: zoo_train takes the first, the
# zoo_grads readings all
ZOO_GRAD_SEEDS = (22, 23, 24)
# The whole gradient of a zoo step against fp32 plain is held against the
# control measured beside it, bf16 plain (the same precision without the
# kernels): at most ZOO_GRAD_CTL_FACTOR times the control's error, and at
# most TRAIN_GRAD_REL_TOL. The factor is set from the zoo_grads readings
# (PERF.md, PR 12): over ZOO_GRAD_SEEDS the kernels' error was 0.981-1.024
# times the control's; K1-K4 with 2 and 3 bits of their outputs cleared
# gave 1.505 and 2.653 (SwinSegFormer), 1.049 and 1.103 (GCViTUNETR).
ZOO_GRAD_CTL_FACTOR = 1.08
# bits of the bf16 mantissa (7) that the zoo_grads controls clear in every
# output of K1-K4: stand-ins for kernels of a lower precision
ZOO_GRAD_COARSE_BITS = (1, 2, 3)
# --n_images_per_batch 4 --grad_accum_steps 2 --fused_loss: per micro-step
# K8 once forward and once backward (for each head), and K5 for the UNETR
# decoder's three full-resolution convs (the UNETR decoders of GCViTUNETR,
# SwInception and SwinDepth: the SegFormer heads have no 3^3 stride-1 conv);
# None: the training CLI runs no batch-4 epoch of that model
ZOO_B4_K5 = {"GCViTUNETR": 3, "SegFormer3D": 0, "SwinSegFormer": 0,
             "SwInception": 3, "SwinDepth": 3,
             # nnFormer's conv stem: its second conv, 24 -> 24 at 96^3 (the
             # first reads one channel, the others a 48^3 grid)
             "nnFormer": 1, "VideoSwinUNETR": None,
             "SwinUNETR_Official": None, "FocalNetUNETR": None,
             "UNETR_Official": None, "LRGFormerUNETR": None}


def _zoo_train_steps(name, batch_size, extra=(), batch_fn=None):
    """ZOO_TRAIN_STEPS steps of ``name`` (with the flags ``extra``) at
    ``batch_size`` on one seeded batch (``_train_batch``, or
    ``batch_fn(batch)`` of it): losses, ms, peak memory, the launches of
    each step (``steps``) and of all of them (``launches``), the routes of
    all of them (added to ROUTE_TOTALS), whether the BatchNorm running
    statistics moved. Fails where the batch does not fit the card."""
    import torch

    from medicalsemseg_tpu_torch.models.layers import BatchNorm

    cfg, model, state, train_step = _train_setup(["--model", name,
                                                  *extra])
    gen = torch.Generator(device="cuda").manual_seed(21)
    batch = _train_batch(gen, batch_size, cfg.output_dim)
    if batch_fn is not None:
        batch = batch_fn(batch)
    stats = [b.clone() for m in model.modules() if isinstance(m, BatchNorm)
             for b in (m.running_mean, m.running_var)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, times, steps, routes = [], [], [], {}
    for step in range(ZOO_TRAIN_STEPS):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            m = train_step(state, batch)
        except torch.cuda.OutOfMemoryError:
            raise PhaseError(
                f"zoo_train {name}: batch {batch_size} no longer fits the "
                "card's memory (peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
                "when it ran out)") from None
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        _require(all(bool(torch.isfinite(u).all()) for u in m.values()),
                 f"zoo_train {name}: non-finite metrics at step {step}")
        steps.append(_read_launches())
        for kernel, by in _read_routes().items():
            for r, n in by.items():
                routes.setdefault(kernel, {}).setdefault(r, 0)
                routes[kernel][r] += n
    launches = {k: sum(s[k] for s in steps) for k in steps[0]}
    routes = _add_routes(f"zoo_train {name}, {ZOO_TRAIN_STEPS} steps", routes)
    moved = [b for m in model.modules() if isinstance(m, BatchNorm)
             for b in (m.running_mean, m.running_var)]
    moved = all(not torch.equal(a, b) for a, b in zip(stats, moved))
    return dict(cfg=cfg, model=model, losses=losses, times=times,
                steps=steps, launches=launches, routes=routes,
                bn=len(stats) // 2,
                bn_moved=moved, peak=torch.cuda.max_memory_allocated())


# the modules held alone against plain in a model's training step: the
# blocks that run kernels, or, in SwInception and SwinDepth, the blocks'
# attention (K1, K3 with the LayerNorm rows as an input): their whole
# blocks carry the plain MLP's bf16 autograd, which turns the kernels' 5e-5
# change of its input into ~8e-3 of its own gradients and 2.5e-3 of the
# attention's (PERF.md, Findings; the control is in zoo_grads)
def _zoo_block_class(name):
    from medicalsemseg_tpu_torch.models.gcvit import GCViTBlock
    from medicalsemseg_tpu_torch.models.swin import SwinBlock, WindowAttention

    return {"GCViTUNETR": GCViTBlock, "SwinSegFormer": SwinBlock,
            "SwInception": WindowAttention,
            "SwinDepth": WindowAttention}.get(name)


def _unfused_ms(model, batch):
    """Device ms of the unfused attentions of one training step (GC-ViT's
    global blocks, SegFormer's attention: K6 and K7 have no backward
    kernel), forward and backward, each call timed alone on the inputs one
    training-mode forward gives it (ROADMAP R17); 0 for a model without
    them."""
    import torch

    from medicalsemseg_tpu_torch.models.gcvit import GCWindowAttention
    from medicalsemseg_tpu_torch.models.segformer import SRAttention

    calls = []
    saved = [(cls, cls.unfused) for cls in (GCWindowAttention, SRAttention)]

    def recorder(orig):
        def record(self, *args):
            calls.append((orig, self, [a.detach() for a in args]))
            return orig(self, *args)
        return record

    for cls, orig in saved:
        cls.unfused = recorder(orig)
    try:
        model.train()
        with torch.no_grad():
            model((batch["image"], batch["crop_loc"], batch["affine"]))
    finally:
        for cls, orig in saved:
            cls.unfused = orig
    total = 0.0
    for orig, mod, args in calls:
        args = [a.clone().requires_grad_(True) for a in args]
        cot = torch.randn_like(orig(mod, *args).detach())

        def fwd_bwd():
            torch.autograd.backward(orig(mod, *args), cot)

        total += _time_ms(fwd_bwd, 3)
    return total, len(calls)


def _zoo_train_cli(name, tmp, batch_size, extra=()):
    """The training CLI on the synthetic set in ``tmp`` (``name`` with the
    flags ``extra``): one epoch at ``batch_size`` with validation and a
    checkpoint, then (where ZOO_B4_K5[name] is not None) one epoch of
    micro-steps at batch 4 with --grad_accum_steps 2 --fused_loss. Requires
    the backward kernels' launches of a step (ZOO_TRAIN_LAUNCHES[name]), K5's
    of a batch-4 micro-step (ZOO_B4_K5[name]) and K8's, once forward and once
    backward for each head (three under --deep_supervision). Returns the
    launches of the runs."""
    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.cli import run_training
    from medicalsemseg_tpu_torch.config import get_args

    bwd, b4_k5 = ZOO_TRAIN_LAUNCHES[name], ZOO_B4_K5[name]
    heads = 3 if "--deep_supervision" in extra else 1
    base = TRAIN_ARGS + list(extra) + [
        "--model", name, "--data_path", tmp, "--task", "Task03_ZooTrain",
        "--t_fixed_ct_intensity", "--t_rand_crop_fgbg", "--t_spatial_pad",
        "--val_interval", "1", "--save_ckpt_freq", "1",
        "--metric_readback_freq", "1", "--epochs", "1"]
    total = {}
    n_train = ZOO_CLI_VOLUMES * 4 // 5     # fold 0 of 5 holds a fifth out
    runs = [(f"batch {batch_size}", ["--n_images_per_batch",
                                     str(batch_size)],
             n_train // batch_size)]
    if b4_k5 is not None:
        runs.append(("batch 4, --grad_accum_steps 2, --fused_loss",
                     TRAIN_B4_FLAGS, n_train // TRAIN_B4_BATCH))
    for tag, extra, micro in runs:
        out = tempfile.mkdtemp(prefix=f"{name}_", dir=tmp)
        _reset_launches()
        t0 = time.perf_counter()
        with _dw27_mode(None):
            run_training.main(get_args(base + extra + [
                "--output_dir", out, "--log_dir", os.path.join(out, "log")]))
        wall = time.perf_counter() - t0
        launches = _read_launches()
        with open(os.path.join(out, "log.txt")) as f:
            row = [json.loads(line) for line in f][-1]
        _require(all(np.isfinite(row[k]) for k in
                     ("train/loss", "train/mDice", "val/loss", "val/mDice")),
                 f"zoo_train {name} CLI {tag}: log.txt row {row}")
        payload = torch.load(os.path.join(out, "checkpoint-0.pth"),
                             weights_only=True)
        _require(payload["step"] == micro,
                 f"zoo_train {name} CLI {tag}: checkpoint step "
                 f"{payload['step']} (want {micro})")
        if "--fused_loss" in extra:
            _require_launches(f"zoo_train {name} CLI {tag}", launches, {
                "dice_ce_sums": heads * micro,
                "dice_ce_dlogits": heads * micro, "dw27": b4_k5 * micro})
        else:
            _require_launches(f"zoo_train {name} CLI {tag}", launches, {
                "dice_ce_sums": 0, "dice_ce_dlogits": 0,
                "dw27": bwd.get("dw27", 0) * micro})
        for k, v in bwd.items():
            if k.endswith("_bwd"):
                _require(launches[k] == v * micro,
                         f"zoo_train {name} CLI {tag}: {k} launched "
                         f"{launches[k]} times (want {v * micro})")
        print(f"zoo_train: {name} CLI {tag}: 1 epoch ({micro} steps, "
              f"validation of {ZOO_CLI_VOLUMES - n_train} volumes) in "
              f"{wall:.1f} s, loss {row['train/loss']:.4f}, val mDice "
              f"{row['val/mDice']:.4f}, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


ZOO_CLI_VOLUMES = 20     # fold 0 of 5: 16 train (2 steps at batch 8), 4 val


class _coarse_kernels:
    """Inside the block K1-K4 (the kernels of a zoo training step) return
    every output with the low ``bits`` of its bf16 mantissa cleared (fp32
    outputs to the same width): stand-ins for kernels of a lower precision,
    the controls of the whole-gradient check (phase zoo_grads)."""

    def __init__(self, bits):
        self.bits = bits

    def __enter__(self):
        import torch

        from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
        from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

        def coarse(t):
            if not isinstance(t, torch.Tensor) or not t.is_floating_point():
                return t
            ints, drop = ((torch.int16, self.bits)
                          if t.dtype == torch.bfloat16
                          else (torch.int32, 16 + self.bits))
            return (t.view(ints) & ~((1 << drop) - 1)).view(t.dtype)

        def wrap(fn):
            def call(*args, **kw):
                out = fn(*args, **kw)
                return (tuple(coarse(t) for t in out)
                        if isinstance(out, tuple) else coarse(out))
            return call

        names = ((kwa, "window_attention"), (kwa, "window_attention_bwd"),
                 (kmlp, "fused_mlp"), (kmlp, "fused_mlp_bwd"))
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in names]
        for mod, name, fn in self.saved:
            setattr(mod, name, wrap(fn))

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _zoo_grad_fn(cfg, seed):
    """grads_of(net) for one training step at batch ZOO_GRAD_BATCH on a
    batch seeded with ``seed``."""
    import torch

    from medicalsemseg_tpu_torch.train.losses import build_loss

    gen = torch.Generator(device="cuda").manual_seed(seed)
    small = _train_batch(gen, ZOO_GRAD_BATCH, cfg.output_dim)
    if cfg.vol_size3() != (CROP,) * 3:      # LRGFormerUNETR at vol 64
        small = _crop_batch(small, cfg.vol_size3())
    loss_fn = build_loss(cfg)

    def grads_of(net):
        return _grads_of(net, loss_fn, small)

    return grads_of


def _zoo_grads(cfg, model, seed, runs):
    """One step's whole gradient of a zoo model (``_zoo_grad_fn``): in bf16
    inside each context of ``runs`` (label -> context manager factory),
    then the fp32 plain reference. Returns {label: (loss, rel norm err
    against fp32 plain)} and (the reference's loss, its peak bytes); the
    model ends bf16."""
    import torch

    grads_of = _zoo_grad_fn(cfg, seed)
    got = {}
    for label, ctx in runs.items():
        with ctx():
            got[label] = grads_of(model)
    want_loss, want, ref_peak = _fp32_plain_grads(model, grads_of)
    model.dtype = torch.bfloat16
    return ({label: (loss, _rel_norm(g, want))
             for label, (loss, g) in got.items()}, (want_loss, ref_peak))


def _zoo_grad_line(name, seed, rel, ref):
    """The readings of one _zoo_grads call, printed; returns the kernels'
    error over the control's (None without kernels in the runs)."""
    ctl = rel["bf16 plain"][1]
    parts = [f"{label} {err:.3e} (loss {loss:.5f})"
             for label, (loss, err) in rel.items()]
    ratio = rel["kernels"][1] / ctl if "kernels" in rel else None
    print(f"zoo_grads: {name} seed {seed}, whole gradient at batch "
          f"{ZOO_GRAD_BATCH}, rel norm err against fp32 plain (loss "
          f"{ref[0]:.5f}, peak {ref[1] / 2 ** 30:.2f} GiB): "
          + "; ".join(parts)
          + (f"; kernels / control {ratio:.3f}" if ratio else ""),
          flush=True)
    return ratio


def phase_zoo_train():
    """GCViTUNETR, SegFormer3D and SwinSegFormer trained at full width: steps
    through make_train_step at batch 8 (launch counts by kernel and route,
    the loss falls, the BatchNorm running statistics move, ms per step, peak
    memory), every kernel-running block alone against plain, one step's
    whole gradient at batch 2 against the fp32 plain path beside the bf16
    plain control, then the training CLI at batch 8 and at batch 4 with
    --grad_accum_steps 2 --fused_loss."""
    import contextlib

    import numpy as np
    import torch

    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        _write_train_set(os.path.join(tmp, "Task03_ZooTrain"),
                         ZOO_CLI_VOLUMES, (128, 120, 100), 14,
                         np.random.default_rng(3))
        for name in ZOO_MODELS:
            t0 = time.perf_counter()
            batch_size = ZOO_TRAIN_BATCH
            run = _zoo_train_steps(name, batch_size)
            torch.cuda.empty_cache()
            launches, routes = run["steps"][-1], run["routes"]
            for k, v in run["launches"].items():
                total[k] = total.get(k, 0) + v
            for i, step in enumerate(run["steps"]):
                _require_launches(f"zoo_train {name} (step {i})", step, {
                    **dict.fromkeys(step, 0), **ZOO_TRAIN_LAUNCHES[name]})
            _require(all(by["cuda_core"] == 0 for by in routes.values()),
                     f"zoo_train {name}: a launch took the CUDA cores "
                     f"{routes}")
            losses = run["losses"]
            _require(losses[-1] < losses[0], f"zoo_train {name}: the loss "
                     f"did not fall: {losses}")
            _require(run["bn"] == 0 or run["bn_moved"],
                     f"zoo_train {name}: the BatchNorm running statistics "
                     "did not move")
            moved = " (running statistics moved)" if run["bn"] else ""
            print(f"zoo_train: {name} batch {batch_size} x 96^3, bf16, "
                  f"{ZOO_TRAIN_STEPS} steps: loss "
                  f"{' '.join(f'{v:.4f}' for v in losses)}; ms per step "
                  f"{' '.join(f'{t:.0f}' for t in run['times'])} (the first "
                  f"includes cuDNN's choice of algorithms); peak device "
                  f"memory {run['peak'] / 2 ** 30:.2f} GiB; BatchNorms "
                  f"{run['bn']}{moved}; launches a step "
                  f"{ {k: v for k, v in launches.items() if v} }",
                  flush=True)

            cfg, model = run["cfg"], run["model"]
            step_ms = min(run["times"][1:])
            del run
            torch.cuda.empty_cache()
            gen = torch.Generator(device="cuda").manual_seed(21)
            ms, calls = _unfused_ms(model, _train_batch(
                gen, batch_size, cfg.output_dim))
            if calls:
                print(f"zoo_train: {name}: the {calls} unfused attentions "
                      f"(no backward kernel, R17), forward and backward, "
                      f"each timed alone: {ms:.1f} ms of a {step_ms:.0f} ms "
                      f"step ({100 * ms / step_ms:.0f} %)", flush=True)
            torch.cuda.empty_cache()

            seed = ZOO_GRAD_SEEDS[0]
            blocks = _zoo_block_class(name)
            if blocks is not None:
                _, found = _blocks_vs_plain(f"zoo_train {name}", model,
                                            _zoo_grad_fn(cfg, seed), blocks)
                _require(found == 8, f"zoo_train {name}: {found} blocks")
            rel, ref = _zoo_grads(cfg, model, seed, {
                "kernels": contextlib.nullcontext,
                "bf16 plain": _plain_kernels})
            ratio = _zoo_grad_line(name, seed, rel, ref)
            limit = min(TRAIN_GRAD_REL_TOL,
                        ZOO_GRAD_CTL_FACTOR * rel["bf16 plain"][1])
            print(f"zoo_train: {name}: the kernels' whole gradient "
                  f"{rel['kernels'][1]:.3e} from fp32 plain, {ratio:.3f} "
                  f"times the control's (tol {limit:.3e}: the smaller of "
                  f"{ZOO_GRAD_CTL_FACTOR} times the control and "
                  f"{TRAIN_GRAD_REL_TOL})", flush=True)
            _require(rel["kernels"][1] <= limit, f"zoo_train {name}: the "
                     "gradients disagree with the fp32 plain path")
            del model
            torch.cuda.empty_cache()

            cli = _zoo_train_cli(name, tmp, batch_size)
            for k, v in cli.items():
                total[k] = total.get(k, 0) + v
            print(f"zoo_train: {name}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    return total


class _attn_shifted:
    """Inside the block the plain versions run, and the attention ``attn``
    returns its output plus ``delta``: the forward's change by the kernels
    without their backward (the control of phase zoo_grads)."""

    def __init__(self, attn, delta):
        self.attn, self.delta = attn, delta

    def __enter__(self):
        self.plain = _plain_kernels()
        self.plain.__enter__()
        self.hook = self.attn.register_forward_hook(
            lambda mod, args, out: out + self.delta)

    def __exit__(self, *exc):
        self.hook.remove()
        self.plain.__exit__(*exc)


def _swin_block_controls(name, model, run):
    """The readings behind holding SwInception's and SwinDepth's attention
    alone (``_zoo_block_class``): each whole SwinBlock (the plain MLP's bf16
    autograd included) against plain with the kernels, and with the plain
    versions whose attention output is shifted by what the kernels change
    of it on the same input (the cause's control: no kernel runs); then
    each attention alone with the kernels and with K1-K4's outputs
    coarsened by ZOO_GRAD_COARSE_BITS (what the 2e-3 limit must catch).
    Prints the worst of each over the blocks."""
    import contextlib

    from medicalsemseg_tpu_torch.models.swin import SwinBlock, WindowAttention

    def group(errs, prefixes):
        return max((v, k) for k, v in errs.items() if k.startswith(prefixes))

    _, inputs = _block_inputs(model, run, SwinBlock)
    whole = {"kernels": [], "plain, attention output shifted": []}
    for block, (args, kwargs) in inputs.items():
        blk = model.get_submodule(block)
        outs = []
        hook = blk.attn.register_forward_hook(
            lambda mod, a, out: outs.append(out.detach()))
        for ctx in (contextlib.nullcontext, _plain_kernels):
            with ctx():
                _seed_drop_path(blk, 11)
                blk(*args, **kwargs)
        hook.remove()
        for label, ctx in (
                ("kernels", contextlib.nullcontext),
                ("plain, attention output shifted",
                 lambda: _attn_shifted(blk.attn, outs[0] - outs[1]))):
            errs = _block_errors(blk, args, kwargs, ctx)
            attn, mlp = group(errs, ("attn.", "norm1.")), group(errs, (
                "mlp.", "norm2."))
            whole[label].append((errs["dx"], attn[0]))
            change = float((outs[0] - outs[1]).float().norm()
                           / outs[1].float().norm())
            print(f"zoo_grads: {name} {block} whole (input "
                  f"{tuple(args[0].shape)}), {label} vs plain: y "
                  f"{errs['y']:.3e}, dx {errs['dx']:.3e}, attention's worst "
                  f"{attn[1]} {attn[0]:.3e}, MLP's worst {mlp[1]} "
                  f"{mlp[0]:.3e} (the kernels change the attention's output "
                  f"by {change:.3e})", flush=True)
        del outs
    for label, errs in whole.items():
        print(f"zoo_grads: {name} control, whole blocks, {label}: worst dx "
              f"{max(e[0] for e in errs):.3e}, worst attention gradient "
              f"{max(e[1] for e in errs):.3e} over {len(errs)} blocks",
              flush=True)
    _, inputs = _block_inputs(model, run, WindowAttention)
    for bits in (0,) + ZOO_GRAD_COARSE_BITS:
        ctx = ((lambda: _coarse_kernels(bits)) if bits
               else contextlib.nullcontext)
        worst = max(max(_block_errors(model.get_submodule(attn), args,
                                      kwargs, ctx).values())
                    for attn, (args, kwargs) in inputs.items())
        label = f"kernels with {bits} bits cleared" if bits else "kernels"
        print(f"zoo_grads: {name} control, each attention alone, {label}: "
              f"worst {worst:.3e} over {len(inputs)} (tol "
              f"{TRAIN_BLOCK_REL_TOL})", flush=True)


def phase_zoo_grads():
    """The readings behind ZOO_GRAD_CTL_FACTOR: each zoo model's, and
    SwInception's and SwinDepth's, whole gradient of one step at batch 2
    against fp32 plain, with the kernels and with bf16 plain (the control),
    on the batches of ZOO_GRAD_SEEDS; on the first, also with K1-K4's
    outputs coarsened by ZOO_GRAD_COARSE_BITS (the controls the check must
    fail), and for SwInception and SwinDepth the block controls of
    ``_swin_block_controls``. SegFormer3D's step runs none of K1-K4."""
    import contextlib

    import torch

    for name in ZOO_MODELS + SWIN_MLP_MODELS:
        cfg, model, _, _ = _train_setup(["--model", name])
        for i, seed in enumerate(ZOO_GRAD_SEEDS):
            runs = {"kernels": contextlib.nullcontext,
                    "bf16 plain": _plain_kernels}
            if i == 0 and _zoo_block_class(name) is not None:
                runs.update({f"kernels with {b} bits cleared":
                             (lambda b=b: _coarse_kernels(b))
                             for b in ZOO_GRAD_COARSE_BITS})
            rel, ref = _zoo_grads(cfg, model, seed, runs)
            _zoo_grad_line(name, seed, rel, ref)
            ctl = rel["bf16 plain"][1]
            for label, (_, err) in rel.items():
                if label.startswith("kernels with"):
                    print(f"zoo_grads: {name} control, {label}: "
                          f"{err / ctl:.3f} times the bf16 plain error",
                          flush=True)
        if name in SWIN_MLP_MODELS:
            _swin_block_controls(name, model,
                                 _zoo_grad_fn(cfg, ZOO_GRAD_SEEDS[0]))
        del model
        torch.cuda.empty_cache()


# ---- the thirteenth slice: SwInception, SwinDepth and every option of the
# Swin encoder, for prediction and training

SWIN_MLP_MODELS = ("SwInception", "SwinDepth")
SWIN_EMBEDDING_FLAGS = ["--learned_cls_vectors", "--lcv_final_layer",
                        "--rel_crop_pos_emb", "--abs_pos_emb", "--patch_size",
                        "2", "2", "1"]
SWIN_ATTENTION_FLAGS = ["--rel_pos_bias_affine", "--global_token"]
# a non-uniform voxel spacing (the affine-scaled bias reads it)
SWIN_OPTS_AFFINE = (0.8, 0.8, 2.5)
# kernel launches of one predictor call and of one training step: the
# inception and depthwise MLPs have no kernel, so those models launch K1
# (K3) in their 8 blocks and no K2 (K4); the attention options take every
# block off K1 / K3 (the unfused attention), not off K2 / K4; in a step the
# forward kernels launch twice a block (REMAT_FORWARDS)
SWIN_OPTS_CALL = {
    "SwInception": {"window_attention": 8},
    "SwinDepth": {"window_attention": 8},
    "embedding": {"window_attention": 8, "fused_mlp": 8},
    "attention": {"fused_mlp": 8},
}
SWIN_OPTS_STEP = {
    **{name: ZOO_TRAIN_LAUNCHES[name] for name in SWIN_MLP_MODELS},
    "embedding": _swin_step_launches(8),
    "attention": _swin_step_launches(8, ("fused_mlp", "fused_mlp_bwd")),
}
SWIN_OPTS_FLAGS = {"SwInception": ["--model", "SwInception"],
                   "SwinDepth": ["--model", "SwinDepth"],
                   "embedding": SWIN_EMBEDDING_FLAGS,
                   "attention": SWIN_ATTENTION_FLAGS}
# K9 (Winograd, bf16) against F.conv3d in bf16 on the same inputs: the
# three input-transform stages each round to bf16 (the TPU kernel's points),
# about twice the direct conv's rounding, as TRAIN_WINO_ALT_REL_TOL says
WINO_LIBRARY_REL_TOL = 2e-2
SWIN_OPTS_GATED_BATCH = 2


def _opts_inputs(n, gen):
    """(volume, per-window crop positions, the non-uniform spacing) of
    ``n`` windows, CPU tensors."""
    import torch

    return (torch.randn(n, 96, 96, 96, 1, generator=gen),
            torch.rand(n, 3, generator=gen),
            torch.tensor(SWIN_OPTS_AFFINE).expand(n, 3).contiguous())


def _opts_batch(gen):
    """A batch_fn of _zoo_train_steps: per-crop positions and the
    non-uniform spacing in place of _train_batch's constants."""
    def fn(batch):
        import torch

        n = batch["image"].shape[0]
        batch["crop_loc"] = torch.rand(n, 3, generator=gen).to("cuda")
        batch["affine"] = torch.tensor(SWIN_OPTS_AFFINE,
                                       device="cuda").expand(n, 3)
        return batch
    return fn


class _held_convs:
    """Inside the block every launch of K5 (``dw27``) and K9
    (``winograd_conv3d_f23``) is also computed by the library on the same
    inputs (cuDNN's weight gradient, ``F.conv3d``) and its relative error
    norm recorded in ``errors`` (name -> list); the library's calls are no
    launches."""

    def __enter__(self):
        import torch
        import torch.nn.functional as F

        from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5
        from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

        self.errors = {"dw27": [], "winograd_conv3d_f23": []}
        self.saved = [(k5, "dw27", k5.dw27),
                      (k9, "winograd_conv3d_f23", k9.winograd_conv3d_f23)]
        ncdhw = lambda t: t.permute(0, 4, 1, 2, 3)  # noqa: E731

        def rel(got, want):
            return float((got.float() - want.float()).norm()
                         / want.float().norm())

        def dw(x, dy, _f=k5.dw27):
            out = _f(x, dy)
            want = torch.nn.grad.conv3d_weight(
                ncdhw(x), (dy.shape[-1], x.shape[-1], 3, 3, 3), ncdhw(dy),
                padding=1)
            self.errors["dw27"].append(
                (tuple(x.shape), dy.shape[-1],
                 rel(out.permute(4, 3, 0, 1, 2), want)))
            return out

        def wino(x, w, *args, _f=k9.winograd_conv3d_f23, **kw):
            out = _f(x, w, *args, **kw)
            want = F.conv3d(ncdhw(x), w, padding=1).permute(0, 2, 3, 4, 1)
            self.errors["winograd_conv3d_f23"].append(
                (tuple(x.shape), w.shape[0], rel(out, want)))
            return out

        k5.dw27, k9.winograd_conv3d_f23 = dw, wino
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _k5_launches_required(model, run):
    """K5's launches of one ``run()`` of ``model`` with MEDSEG_DW27_PALLAS=1,
    from the port's gate (``dw27_eligible``) and the input of every 3^3 /
    stride-1 conv whose weight takes a gradient, seen by hooks in a run
    with the gate shut."""
    from medicalsemseg_tpu_torch.models.layers import remat_replaying
    from medicalsemseg_tpu_torch.ops import convgrad

    count = [0]

    def hook(mod, args, out):
        if remat_replaying():   # a block's recompute: no second dW
            return
        with _dw27_mode("1"):
            count[0] += int(mod.weight.requires_grad
                            and convgrad.dw27_eligible(args[0].shape))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if _is_conv3_s1(m)]
    with _dw27_mode("0"):
        run()
    for h in hooks:
        h.remove()
    return count[0]


def _swin_opts_predict_cli(tmp):
    """The prediction CLI with the embedding options on a synthetic CT
    volume: K1 and K2 in all 8 blocks of every predictor call. Returns its
    launches. (No --tta_mirror rerun: the cli phase holds --tta_mirror,
    whose flips act on the predictor's input whatever the encoder's
    options.)"""
    import numpy as np

    from medicalsemseg_tpu_torch.cli import run_test
    from medicalsemseg_tpu_torch.data import nifti

    task = os.path.join(tmp, "Task09_SwinOpts")
    os.makedirs(os.path.join(task, "imagesTs"))
    rng = np.random.default_rng(13)
    aff = np.diag([0.8, 0.8, 2.5, 1.0])
    nifti.save(nifti.NiftiImage(_ct_volume(rng, (200, 180, 120)), aff),
               os.path.join(task, "imagesTs", "ct0.nii.gz"))
    with open(os.path.join(task, "dataset.json"), "w") as f:
        json.dump({"training": [], "test": ["./imagesTs/ct0.nii.gz"]}, f)
    total = {}
    for tta in ([],):
        out = tempfile.mkdtemp(prefix="pred_", dir=tmp)
        cfg = run_test.get_args(
            FLAGSHIP_ARGS + SWIN_EMBEDDING_FLAGS + tta + [
                "--data_path", tmp, "--task", "Task09_SwinOpts",
                "--output_dir", out, "--device", "cuda"])
        _reset_launches()
        t0 = time.perf_counter()
        records = run_test.main(cfg)
        wall = time.perf_counter() - t0
        launches = _read_launches()
        calls = sum(r["predictor_calls"] for r in records)
        _require(calls > 0, "swin_opts CLI: no predictor call")
        _require_launches(
            f"swin_opts CLI embedding options {' '.join(tta)}", launches,
            {**dict.fromkeys(launches, 0),
             **{k: v * calls for k, v in SWIN_OPTS_CALL["embedding"].items()}})
        preds = os.listdir(os.path.join(out, "test_output", "Fold0", "pred"))
        _require(len(preds) == 1, f"swin_opts CLI: predictions {preds}")
        print(f"swin_opts: prediction CLI, flagship with "
              f"{' '.join(SWIN_EMBEDDING_FLAGS)} {' '.join(tta)} on a "
              f"200x180x120 CT volume (spacing 0.8 0.8 2.5): {calls} "
              f"predictor calls, {wall:.1f} s, windows "
              f"{[r['windows'] for r in records]}", flush=True)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def _swin_opts_train(tag, name, extra, batch_size, batch_fn, tmp=None):
    """Steps of the model at ``batch_size`` (the launches of every step must
    be SWIN_OPTS_STEP[tag]; the loss falls; the BatchNorms' statistics
    move); the modules of ``_zoo_block_class(name)`` alone against plain;
    the whole gradient of a batch-2 step against fp32 plain beside the bf16
    plain control; with ``tmp`` (the synthetic set's folder) the training
    CLI at that batch and at batch 4 with accumulation and the fused loss.
    Returns the launches."""
    import contextlib

    import torch

    from medicalsemseg_tpu_torch.ops import convgrad

    # both models fit batch 8 (PERF.md, Findings): a batch that no longer fits
    # fails the phase
    run = _zoo_train_steps(name, batch_size, extra, batch_fn)
    total, routes = dict(run["launches"]), run["routes"]
    # K5 for the decoder's three full-resolution convs where the auto
    # window of MEDSEG_DW27_PALLAS opens (batch 2-4 of 96^3)
    with _dw27_mode(None):
        k5 = 3 * convgrad.dw27_eligible((batch_size, CROP, CROP, CROP, 48))
    for i, step in enumerate(run["steps"]):
        _require_launches(f"swin_opts {tag} (step {i})", step, {
            **dict.fromkeys(step, 0), **SWIN_OPTS_STEP[tag], "dw27": k5})
    _require(all(by["cuda_core"] == 0 for by in routes.values()),
             f"swin_opts {tag}: a launch took the CUDA cores {routes}")
    losses = run["losses"]
    _require(losses[-1] < losses[0], f"swin_opts {tag}: the loss did not "
             f"fall: {losses}")
    _require(run["bn"] == 0 or run["bn_moved"], f"swin_opts {tag}: the "
             "BatchNorm running statistics did not move")
    print(f"swin_opts: {tag} batch {batch_size} x 96^3, bf16, "
          f"{ZOO_TRAIN_STEPS} steps: loss "
          f"{' '.join(f'{v:.4f}' for v in losses)}; ms per step "
          f"{' '.join(f'{t:.0f}' for t in run['times'])} (the first includes "
          f"cuDNN's choice of algorithms); peak device memory "
          f"{run['peak'] / 2 ** 30:.2f} GiB; BatchNorms {run['bn']}; "
          f"launches a step "
          f"{ {k: v for k, v in run['steps'][-1].items() if v} }",
          flush=True)
    cfg, model = run["cfg"], run["model"]
    del run
    torch.cuda.empty_cache()
    seed = ZOO_GRAD_SEEDS[0]
    blocks = _zoo_block_class(name)
    if blocks is not None:
        _, found = _blocks_vs_plain(f"swin_opts {tag}", model,
                                    _zoo_grad_fn(cfg, seed), blocks)
        _require(found == 8, f"swin_opts {tag}: {found} attentions")
    rel, ref = _zoo_grads(cfg, model, seed, {
        "kernels": contextlib.nullcontext, "bf16 plain": _plain_kernels})
    ratio = _zoo_grad_line(f"swin_opts {tag}", seed, rel, ref)
    limit = min(TRAIN_GRAD_REL_TOL, ZOO_GRAD_CTL_FACTOR * rel["bf16 plain"][1])
    print(f"swin_opts: {tag}: the kernels' whole gradient "
          f"{rel['kernels'][1]:.3e} from fp32 plain, {ratio:.3f} times the "
          f"control's (tol {limit:.3e})", flush=True)
    _require(rel["kernels"][1] <= limit, f"swin_opts {tag}: the gradients "
             "disagree with the fp32 plain path")
    del model
    torch.cuda.empty_cache()
    if tmp is not None:
        for k, v in _zoo_train_cli(name, tmp, batch_size, extra).items():
            total[k] = total.get(k, 0) + v
    return total


def _swin_opts_gated():
    """One SwInception training step at batch 2 with MEDSEG_DW27_PALLAS=1
    and MEDSEG_WINOGRAD_TRAIN=1: K5 takes the weight gradient of every 3^3
    conv with 16 or more input channels (the inception convs of stages 3
    and 4 among them, 24 -> 153 and 48 -> 307 on its CUDA-core route), K9
    the forward of every conv with 16-127 input channels and the input
    gradient where the output gradient has 16-127 channels, at grids the
    JAX gate keeps on XLA (24, 12, 6). Each launch against the library on
    the same inputs; the launch counts as the gates give them."""
    import torch

    from medicalsemseg_tpu_torch.train.losses import build_loss

    cfg, model, state, train_step = _train_setup(["--model", "SwInception"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = _train_batch(gen, SWIN_OPTS_GATED_BATCH, cfg.output_dim)
    loss_fn = build_loss(cfg)
    run = lambda: _grads_of(model, loss_fn, batch)  # noqa: E731
    need_k9 = _k9_launches_required(model, run, "MEDSEG_WINOGRAD_TRAIN")
    need_k5 = _k5_launches_required(model, run)
    with _gates("MEDSEG_WINOGRAD_TRAIN"), _dw27_mode("1"), \
            _held_convs() as held:
        _reset_launches()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        launches = _read_launches()
    _require(bool(torch.isfinite(m["loss"])), "swin_opts gated: loss")
    _require_launches("swin_opts gated step", launches, {
        "dw27": need_k5, "winograd_conv3d_f23": need_k9,
        **_swin_step_launches(8, ("window_attention",
                                  "window_attention_bwd"))})
    for name, tol in (("dw27", LIBRARY_REL_TOL),
                      ("winograd_conv3d_f23", WINO_LIBRARY_REL_TOL)):
        errs = held.errors[name]
        _require(len(errs) == launches[name], f"swin_opts gated: {name} "
                 f"held {len(errs)} of {launches[name]} launches")
        shapes = sorted({(s[-1], co) for s, co, _ in errs})
        worst = max(errs, key=lambda e: e[2])
        print(f"swin_opts: gated SwInception step (batch "
              f"{SWIN_OPTS_GATED_BATCH}): {name} {len(errs)} launches, "
              f"channels in -> out {shapes}, each against the library: "
              f"worst rel norm err {worst[2]:.3e} at {worst[0]} -> "
              f"{worst[1]} (tol {tol})", flush=True)
        _require(worst[2] <= tol, f"swin_opts gated: {name} at {worst[0]} "
                 f"-> {worst[1]} disagrees with the library")
    del model, state
    torch.cuda.empty_cache()
    return launches


def phase_swin_opts():
    """SwInception and SwinDepth at full width (bf16 card vs fp32 CPU on one
    window, one predictor call of 16 windows, training at batch 8 with the
    blocks alone and the whole gradient checked, the training CLI), the
    flagship with the embedding options (the prediction CLI, also with
    --tta_mirror, and training steps) and with the attention options (logits
    against the fp32 CPU reference, one predictor call, training steps), and
    one SwInception step under the K5 and K9 gates."""
    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.config import get_args

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    gen = torch.Generator().manual_seed(9)
    for tag in SWIN_MLP_MODELS + ("attention",):
        cfg = get_args(_zoo_args("nnFormerUNETR") + SWIN_OPTS_FLAGS[tag])
        add(_model_vs_cpu(f"swin_opts: {tag}", cfg, SWIN_OPTS_CALL[tag],
                          _opts_inputs(1, gen),
                          _opts_inputs(PREDICT_BATCH, gen))[0])
    with tempfile.TemporaryDirectory() as tmp:
        add(_swin_opts_predict_cli(tmp))
        _write_train_set(os.path.join(tmp, "Task03_ZooTrain"),
                         ZOO_CLI_VOLUMES, (128, 120, 100), 14,
                         np.random.default_rng(3))
        tgen = torch.Generator().manual_seed(10)
        for tag in SWIN_MLP_MODELS:
            t0 = time.perf_counter()
            add(_swin_opts_train(tag, tag, (), ZOO_TRAIN_BATCH,
                                 _opts_batch(tgen), tmp))
            print(f"swin_opts: {tag} training: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        for tag in ("embedding", "attention"):
            add(_swin_opts_train(tag, "nnFormerUNETR", SWIN_OPTS_FLAGS[tag],
                                 ZOO_GRAD_BATCH, _opts_batch(tgen)))
    add(_swin_opts_gated())
    return total


# ---- the fourteenth slice: the official nnFormer and MONAI's Swin block
# family (VideoSwinUNETR, SwinUNETR_Official), for prediction, training and
# evaluation

ZOO_OFFICIAL_MODELS = ("nnFormer", "VideoSwinUNETR", "SwinUNETR_Official")
OFFICIAL_GATE = "MEDSEG_OFFICIAL_FUSED"
# kernel launches of one predictor call: nnFormer's 8 encoder and 3 decoder
# Swin blocks (K1, K2) and its 3 cross blocks' MLPs (K2); the MONAI blocks'
# 8 (K1, K2), SwinUNETR_Official's only with the gate on
ZOO_OFFICIAL_CALL = {
    "nnFormer": {"window_attention": 11, "fused_mlp": 14},
    "VideoSwinUNETR": {"window_attention": 8, "fused_mlp": 8},
    "SwinUNETR_Official": {"window_attention": 8, "fused_mlp": 8},
}
# K1's heads launches of one call on the CUDA cores: SwinUNETR_Official's
# 7^3 windows at stages 1-3 (343 tokens, over the tensor-core route's 224)
ZOO_OFFICIAL_CUDA_CORE = {"window_attention": 6}
# flags of the training runs: nnFormer with its three deep-supervision heads
ZOO_OFFICIAL_TRAIN_FLAGS = {"nnFormer": ["--deep_supervision"],
                            "VideoSwinUNETR": [], "SwinUNETR_Official": []}


class _held_launches:
    """Inside the block every launch of K1 (``window_attention``) and K2
    (``fused_mlp``) is also computed by its plain version on the same
    inputs on the card and held against it (KERNEL_ATOL + KERNEL_RTOL |ref|
    elementwise); ``errors`` maps each kernel to (input shape, max abs err,
    within tolerance) per launch. The plain calls are no launches."""

    def __enter__(self):
        import torch

        from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
        from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

        self.errors = {"window_attention": [], "fused_mlp": []}
        self.saved = [(kwa, "window_attention", kwa.window_attention),
                      (kmlp, "fused_mlp", kmlp.fused_mlp)]

        def held(name, fn, plain):
            def call(*args, **kw):
                out = fn(*args, **kw)
                want = plain(*args, **{k: v for k, v in kw.items()
                                       if k not in ("route", "gemm_route")})
                g, w = out.float(), want.float()
                err = (g - w).abs()
                ok = (bool(torch.isfinite(g).all()) and bool(
                    (err <= KERNEL_ATOL + KERNEL_RTOL * w.abs()).all()))
                self.errors[name].append((tuple(args[0].shape),
                                          float(err.max()), ok))
                return out
            return call

        kwa.window_attention = held("window_attention", kwa.window_attention,
                                    kwa.window_attention_plain)
        kmlp.fused_mlp = held("fused_mlp", kmlp.fused_mlp,
                              kmlp.fused_mlp_plain)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _official_predict_cli(tmp):
    """The prediction CLI on the 200x180x120 CT volume: nnFormer, also with
    --ref_quirk_rel_pos, VideoSwinUNETR, SwinUNETR_Official with the gate on
    (K1 on the CUDA cores at its 7^3 windows) and off (no kernel). Returns
    the launches of all runs."""
    import numpy as np

    from medicalsemseg_tpu_torch.cli import run_test
    from medicalsemseg_tpu_torch.data import nifti

    task = os.path.join(tmp, "Task10_Official")
    os.makedirs(os.path.join(task, "imagesTs"))
    nifti.save(nifti.NiftiImage(_ct_volume(np.random.default_rng(14),
                                           EVAL_SHAPES[1]),
                                np.diag([0.8, 0.8, 2.5, 1.0])),
               os.path.join(task, "imagesTs", "ct0.nii.gz"))
    with open(os.path.join(task, "dataset.json"), "w") as f:
        json.dump({"training": [], "test": ["./imagesTs/ct0.nii.gz"]}, f)
    total = {}
    for name, extra, gate in (
            ("nnFormer", [], None), ("nnFormer", ["--ref_quirk_rel_pos"], None),
            ("VideoSwinUNETR", [], None), ("SwinUNETR_Official", [], "1"),
            ("SwinUNETR_Official", [], None)):
        label = " ".join([name] + extra + ([f"{OFFICIAL_GATE}={gate}"]
                                           if gate else []))
        want = ZOO_OFFICIAL_CALL[name] if gate or name != \
            "SwinUNETR_Official" else {}
        out = tempfile.mkdtemp(prefix="pred_", dir=tmp)
        with _env_var(OFFICIAL_GATE, gate):
            cfg = run_test.get_args(_zoo_args(name) + extra + [
                "--data_path", tmp, "--task", "Task10_Official",
                "--output_dir", out, "--device", "cuda"])
            _reset_launches()
            t0 = time.perf_counter()
            records = run_test.main(cfg)
            wall = time.perf_counter() - t0
        launches = _read_launches()
        calls = sum(r["predictor_calls"] for r in records)
        _require(calls > 0, f"zoo_official CLI {label}: no predictor call")
        _check_routes(f"zoo_official CLI {label}", "tensor_core",
                      need=bool(want), other_routes={
                          k: v * calls for k, v in (
                              ZOO_OFFICIAL_CUDA_CORE if gate else {}).items()})
        _require_launches(f"zoo_official CLI {label}", launches,
                          {**dict.fromkeys(launches, 0),
                           **{k: v * calls for k, v in want.items()}})
        pred = nifti.load(os.path.join(out, "test_output", "Fold0", "pred",
                                       "ct0.nii.gz")).data
        _require(pred.shape == EVAL_SHAPES[1] and int(pred.max()) < 14,
                 f"zoo_official CLI {label}: prediction {pred.shape}")
        print(f"zoo_official: prediction CLI, {label} on a 200x180x120 CT "
              f"volume: {calls} predictor calls, predicted in "
              f"{records[0]['predict_seconds']:.2f} s, {wall:.1f} s in all",
              flush=True)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def _official_eval(tmp):
    """The labelled evaluation CLI of nnFormer with --device_hd95 on the
    200x180x120 CT volume with 13 seeded organ labels. Returns its
    launches."""
    import numpy as np

    from medicalsemseg_tpu_torch.cli import run_evaluation
    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.data import nifti

    rng = np.random.default_rng(15)
    task = "Task11_OfficialEval"
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(tmp, task, sub))
    aff = np.diag([0.8, 0.8, 2.5, 1.0])
    nifti.save(nifti.NiftiImage(_ct_volume(rng, EVAL_SHAPES[1]), aff),
               os.path.join(tmp, task, "imagesTr", "img0.nii.gz"))
    nifti.save(nifti.NiftiImage(_label_volume(rng, EVAL_SHAPES[1]), aff),
               os.path.join(tmp, task, "labelsTr", "img0.nii.gz"))
    with open(os.path.join(tmp, task, "dataset.json"), "w") as f:
        json.dump({"training": [], "validation": [
            {"image": "./imagesTr/img0.nii.gz",
             "label": "./labelsTr/img0.nii.gz"}]}, f)
    cfg = get_args(_zoo_args("nnFormer") + [
        "--device_hd95", "--data_path", tmp, "--task", task, "--output_dir",
        os.path.join(tmp, "out_eval"), "--device", "cuda"])
    _reset_launches()
    t0 = time.perf_counter()
    res = run_evaluation.main(cfg)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    _check_routes("zoo_official eval nnFormer", "tensor_core")
    calls = sum(r["predictor_calls"] for r in res["records"])
    _require(len(res["records"]) == 1 and calls > 0,
             f"zoo_official eval: {len(res['records'])} volumes, {calls} "
             "predictor calls")
    _require_launches(f"zoo_official eval ({calls} predictor calls)",
                      launches, {**dict.fromkeys(launches, 0),
                                 **{k: v * calls for k, v in
                                    ZOO_OFFICIAL_CALL["nnFormer"].items()}})
    _require(np.isfinite(res["mDice"]), "zoo_official eval: mDice")
    r = res["records"][0]
    print(f"zoo_official: evaluation CLI, nnFormer --device_hd95 on "
          f"{r['shape']}: {calls} predictor calls, predict_seconds "
          f"{r['predict_seconds']:.3f}, hd95_seconds {r['hd95_seconds']:.3f}, "
          f"mDice {res['mDice']:.4f}, mHD95 {res['mHD95']:.3f}, {wall:.1f} s",
          flush=True)
    return launches


def _official_train(name, tmp):
    """Steps of ``name`` at batch 8 (a batch that no longer fits fails the
    phase), every step's launches as ZOO_TRAIN_LAUNCHES says, the loss
    falling; for nnFormer, the one of the three that trains through kernels,
    its Swin-block attentions alone against plain and the whole gradient of
    a batch-2 step against fp32 plain beside the bf16 plain control (the
    MONAI blocks train plain, so there the two runs would be one
    computation); the training CLI at batch 8, and nnFormer's also at batch
    4 with --grad_accum_steps 2 --fused_loss (K8 for each of its three
    heads). Returns the launches."""
    import contextlib

    import torch

    from medicalsemseg_tpu_torch.models.swin import WindowAttention

    extra = ZOO_OFFICIAL_TRAIN_FLAGS[name]
    batch = ZOO_TRAIN_BATCH
    run = _zoo_train_steps(name, batch, extra)
    total = dict(run["launches"])
    for i, step in enumerate(run["steps"]):
        _require_launches(f"zoo_official {name} (step {i})", step, {
            **dict.fromkeys(step, 0), **ZOO_TRAIN_LAUNCHES[name]})
    _require(all(by["cuda_core"] == 0 for by in run["routes"].values()),
             f"zoo_official {name}: a launch took the CUDA cores "
             f"{run['routes']}")
    losses = run["losses"]
    _require(losses[-1] < losses[0], f"zoo_official {name}: the loss did not "
             f"fall: {losses}")
    print(f"zoo_official: {name} {' '.join(extra)} batch {batch} x 96^3, "
          f"bf16, {ZOO_TRAIN_STEPS} steps: loss "
          f"{' '.join(f'{v:.4f}' for v in losses)}; ms per step "
          f"{' '.join(f'{t:.0f}' for t in run['times'])} (the first includes "
          f"cuDNN's choice of algorithms); peak device memory "
          f"{run['peak'] / 2 ** 30:.2f} GiB; launches a step "
          f"{ {k: v for k, v in run['steps'][-1].items() if v} }",
          flush=True)
    cfg, model = run["cfg"], run["model"]
    del run
    torch.cuda.empty_cache()
    seed = ZOO_GRAD_SEEDS[0]
    if ZOO_TRAIN_LAUNCHES[name]:
        _, found = _blocks_vs_plain(f"zoo_official {name}", model,
                                    _zoo_grad_fn(cfg, seed), WindowAttention)
        _require(found == ZOO_TRAIN_LAUNCHES[name]["window_attention"],
                 f"zoo_official {name}: {found} attentions")
        rel, ref = _zoo_grads(cfg, model, seed, {
            "kernels": contextlib.nullcontext, "bf16 plain": _plain_kernels})
        ratio = _zoo_grad_line(f"zoo_official {name}", seed, rel, ref)
        limit = min(TRAIN_GRAD_REL_TOL,
                    ZOO_GRAD_CTL_FACTOR * rel["bf16 plain"][1])
        print(f"zoo_official: {name}: the whole gradient with the kernels "
              f"{rel['kernels'][1]:.3e} from fp32 plain, {ratio:.3f} times "
              f"the control's (tol {limit:.3e})", flush=True)
        _require(rel["kernels"][1] <= limit, f"zoo_official {name}: the "
                 "gradients disagree with the fp32 plain path")
    del model
    torch.cuda.empty_cache()
    cli = _zoo_train_cli(name, tmp, batch, extra)
    for k, v in cli.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_zoo_official():
    """nnFormer, VideoSwinUNETR and SwinUNETR_Official at full width: one
    window bf16 card vs fp32 CPU and one predictor call of 16 windows with
    every K1 / K2 launch held against plain (SwinUNETR_Official with
    MEDSEG_OFFICIAL_FUSED=1 and without), the prediction CLI (also nnFormer
    with --ref_quirk_rel_pos and both gates of SwinUNETR_Official),
    nnFormer's labelled evaluation with --device_hd95, and each model's
    training (steps, gradients, the CLI)."""
    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.config import get_args

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    gen = torch.Generator().manual_seed(16)
    vol = torch.randn(1, 96, 96, 96, 1, generator=gen)
    x_in = (vol, torch.full((1, 3), 0.5), torch.ones(1, 3))
    xb = tuple(torch.cat([t] * PREDICT_BATCH) for t in x_in)
    t0 = time.perf_counter()
    for name in ("nnFormer", "VideoSwinUNETR"):
        add(_model_vs_cpu(f"zoo_official: {name}", get_args(_zoo_args(name)),
                          ZOO_OFFICIAL_CALL[name], x_in, xb, held=True)[0])
    ref = None
    for gate in ("1", None):
        with _env_var(OFFICIAL_GATE, gate):
            launches, ref = _model_vs_cpu(
                f"zoo_official: SwinUNETR_Official ({OFFICIAL_GATE}="
                f"{gate or 'unset'})", get_args(_zoo_args("SwinUNETR_Official")),
                ZOO_OFFICIAL_CALL["SwinUNETR_Official"] if gate else {}, x_in,
                xb, ZOO_OFFICIAL_CUDA_CORE if gate else None, ref, held=True)
        add(launches)
    print(f"zoo_official: prediction: {time.perf_counter() - t0:.1f} s",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        add(_official_predict_cli(tmp))
        add(_official_eval(tmp))
        print(f"zoo_official: the CLIs: {time.perf_counter() - t0:.1f} s",
              flush=True)
        _write_train_set(os.path.join(tmp, "Task03_ZooTrain"),
                         ZOO_CLI_VOLUMES, (128, 120, 100), 14,
                         np.random.default_rng(3))
        for name in ZOO_OFFICIAL_MODELS:
            t0 = time.perf_counter()
            add(_official_train(name, tmp))
            print(f"zoo_official: {name} training: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    return total


# ---- the fifteenth slice: the last four models of the zoo, FocalNetUNETR,
# UNETR_Official, LRGFormerUNETR and Swin2D, for prediction, training and
# evaluation

ZOO_REST_MODELS = ("FocalNetUNETR", "UNETR_Official", "LRGFormerUNETR")
# the volume each model runs at: LRGFormerUNETR fails at 96 in the JAX
# package (its grid bookkeeping) and so raises in the port; 64 and 128 run
ZOO_REST_VOL = {"FocalNetUNETR": 96, "UNETR_Official": 96,
                "LRGFormerUNETR": 64}
LRG_BIG_VOL = 128
# kernel launches of one predictor call: K2 in FocalNet's 8 blocks and in
# ViT-B's 12 (their global and focal mixing is plain PyTorch, as XLA in
# JAX); LRGFormer reaches no kernel in either package
ZOO_REST_CALL = {"FocalNetUNETR": {"fused_mlp": 8},
                 "UNETR_Official": {"fused_mlp": 12},
                 "LRGFormerUNETR": {}}
# Swin2D through build_model: 16 images of 384^2 at patch 2 and window 6,
# which divides every stage's grid (192, 96, 48, 24)
SWIN2D_ARGS = ["--model", "Swin2D", "--input_dim", "2", "--vol_size", "384",
               "--patch_size", "2", "--window_size", "6", "--hidden_dim",
               "48", "--depths", "2", "2", "2", "2", "--num_heads", "3", "6",
               "12", "24", "--output_dim", "14"]
# FocalNet's focal layers at the default window 6: depthwise kernels of 6^3
# and 8^3 at stage 1 of a predictor call (16 x 48^3 x 48)
FOCAL_KERNELS = (6, 8)


def _zoo_rest_args(name, vol=None):
    return _zoo_args(name) + ["--vol_size", str(vol or ZOO_REST_VOL[name])]


def _crop_batch(batch, dims):
    """``_train_batch``'s 96^3 crops cut to ``dims`` (a smaller volume)."""
    d, h, w = dims
    return {**batch, "image": batch["image"][:, :d, :h, :w].contiguous(),
            "label": batch["label"][:, :d, :h, :w].contiguous()}


def _zoo_rest_predict_cli(tmp):
    """The prediction CLI on the 200x180x120 CT volume: FocalNetUNETR, also
    with MEDSEG_FUSED_DECODER=1 (K9 in its UNETR decoder, as the flagship's),
    UNETR_Official (its decoder never fuses) and LRGFormerUNETR at vol 64.
    Returns the launches of all runs."""
    import numpy as np

    from medicalsemseg_tpu_torch.cli import run_test
    from medicalsemseg_tpu_torch.data import nifti

    task = os.path.join(tmp, "Task12_ZooRest")
    os.makedirs(os.path.join(task, "imagesTs"))
    nifti.save(nifti.NiftiImage(_ct_volume(np.random.default_rng(17),
                                           EVAL_SHAPES[1]),
                                np.diag([0.8, 0.8, 2.5, 1.0])),
               os.path.join(task, "imagesTs", "ct0.nii.gz"))
    with open(os.path.join(task, "dataset.json"), "w") as f:
        json.dump({"training": [], "test": ["./imagesTs/ct0.nii.gz"]}, f)
    total = {}
    for name, gate in (("FocalNetUNETR", None),
                       ("FocalNetUNETR", "MEDSEG_FUSED_DECODER"),
                       ("UNETR_Official", None), ("LRGFormerUNETR", None)):
        label = name + (f" {gate}=1" if gate else "")
        out = tempfile.mkdtemp(prefix="pred_", dir=tmp)
        cfg = run_test.get_args(_zoo_rest_args(name) + [
            "--data_path", tmp, "--task", "Task12_ZooRest", "--output_dir",
            out, "--device", "cuda"])
        with _gates(*((gate,) if gate else ())):
            _reset_launches()
            t0 = time.perf_counter()
            records = run_test.main(cfg)
            wall = time.perf_counter() - t0
        launches = _read_launches()
        calls = sum(r["predictor_calls"] for r in records)
        _require(calls > 0, f"zoo_rest CLI {label}: no predictor call")
        _check_routes(f"zoo_rest CLI {label}", "tensor_core",
                      need=bool(ZOO_REST_CALL[name]))
        k9 = launches["winograd_conv3d_f23"]
        _require(bool(gate) == (k9 > 0) and k9 % calls == 0,
                 f"zoo_rest CLI {label}: K9 launched {k9} times in {calls} "
                 "predictor calls")
        _require_launches(f"zoo_rest CLI {label}", launches, {
            **dict.fromkeys(launches, 0), "winograd_conv3d_f23": k9,
            **{k: v * calls for k, v in ZOO_REST_CALL[name].items()}})
        pred = nifti.load(os.path.join(out, "test_output", "Fold0", "pred",
                                       "ct0.nii.gz")).data
        _require(pred.shape == EVAL_SHAPES[1] and int(pred.max()) < 14,
                 f"zoo_rest CLI {label}: prediction {pred.shape}")
        print(f"zoo_rest: prediction CLI, {label} (roi {ZOO_REST_VOL[name]}) "
              f"on a 200x180x120 CT volume: {calls} predictor calls"
              + (f", K9 {k9 // calls} a call" if gate else "")
              + f", predicted in {records[0]['predict_seconds']:.2f} s, "
              f"{wall:.1f} s in all", flush=True)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def _zoo_rest_train(name, tmp):
    """4 steps of ``name`` at batch 8 (the MLPs train plain in both
    packages; LRGFormerUNETR's decoder takes K5 at this batch, each launch
    then held against cuDNN in one more step; the loss falls), the whole
    gradient of a batch-2 step in bf16 against fp32 plain at
    TRAIN_GRAD_REL_TOL (no kernel runs at batch 2, so the bf16 run is its
    own plain control), then the training CLI at batch 8. Returns the
    launches."""
    import torch

    vol = ZOO_REST_VOL[name]
    extra = ["--vol_size", str(vol)]
    crop = (lambda b: _crop_batch(b, (vol,) * 3)) if vol != CROP else None
    run = _zoo_train_steps(name, ZOO_TRAIN_BATCH, extra, crop)
    total = dict(run["launches"])
    for i, step in enumerate(run["steps"]):
        _require_launches(f"zoo_rest {name} (step {i})", step, {
            **dict.fromkeys(step, 0), **ZOO_TRAIN_LAUNCHES[name]})
    losses = run["losses"]
    _require(losses[-1] < losses[0], f"zoo_rest {name}: the loss did not "
             f"fall: {losses}")
    print(f"zoo_rest: {name} batch {ZOO_TRAIN_BATCH} x {vol}^3, bf16, "
          f"{ZOO_TRAIN_STEPS} steps: loss "
          f"{' '.join(f'{v:.4f}' for v in losses)}; ms per step "
          f"{' '.join(f'{t:.0f}' for t in run['times'])} (the first includes "
          f"cuDNN's choice of algorithms); peak device memory "
          f"{run['peak'] / 2 ** 30:.2f} GiB", flush=True)
    cfg, model = run["cfg"], run["model"]
    del run
    torch.cuda.empty_cache()
    need_k5 = ZOO_TRAIN_LAUNCHES[name].get("dw27", 0)
    if need_k5:
        # one more step's forward and backward with every K5 launch held
        # against cuDNN's weight gradient on the same tensors
        from medicalsemseg_tpu_torch.train.losses import build_loss

        gen = torch.Generator(device="cuda").manual_seed(21)
        batch = _train_batch(gen, ZOO_TRAIN_BATCH, cfg.output_dim)
        if crop is not None:
            batch = crop(batch)
        with _held_convs() as held:
            _reset_launches()
            _grads_of(model, build_loss(cfg), batch)
            launches = _read_launches()
        errs = held.errors["dw27"]
        _require(launches["dw27"] == len(errs) == need_k5, f"zoo_rest "
                 f"{name}: K5 launched {launches['dw27']} times, held "
                 f"{len(errs)} (want {need_k5})")
        worst = max(errs, key=lambda e: e[2])
        print(f"zoo_rest: {name} batch {ZOO_TRAIN_BATCH}: each of the "
              f"{len(errs)} K5 launches against cuDNN's weight gradient: "
              f"worst rel norm err {worst[2]:.3e} at {worst[0]} -> "
              f"{worst[1]} (tol {LIBRARY_REL_TOL})", flush=True)
        _require(worst[2] <= LIBRARY_REL_TOL, f"zoo_rest {name}: a K5 "
                 "launch disagrees with cuDNN's weight gradient")
        total["dw27"] += need_k5
        del batch
        torch.cuda.empty_cache()
    rel, ref = _zoo_grads(cfg, model, ZOO_GRAD_SEEDS[0],
                          {"bf16 plain": _plain_kernels})
    _zoo_grad_line(f"zoo_rest {name}", ZOO_GRAD_SEEDS[0], rel, ref)
    _require(rel["bf16 plain"][1] <= TRAIN_GRAD_REL_TOL,
             f"zoo_rest {name}: the bf16 gradient is {rel['bf16 plain'][1]:.3e}"
             f" from fp32 plain (tol {TRAIN_GRAD_REL_TOL})")
    del model
    torch.cuda.empty_cache()
    cli = _zoo_train_cli(name, tmp, ZOO_TRAIN_BATCH, extra)
    for k, v in cli.items():
        total[k] = total.get(k, 0) + v
    return total


def _lrg_big_call():
    """LRGFormerUNETR at vol 128: one predictor call of 16 windows (33,281
    tokens a window at stage 1: the chunked attention's logits of one chunk
    are 16 x 3 x 2048 x 33,281 fp32, 13 GB) in bf16, its time and peak
    memory, against the same call in fp32 on the card (TF32 off; four
    windows at a time: the windows are independent)."""
    import copy

    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.config import get_args

    from medicalsemseg_tpu_torch.models.lrgformer import lrg_stage_grids

    cfg = get_args(_zoo_rest_args("LRGFormerUNETR", LRG_BIG_VOL))
    gen = torch.Generator().manual_seed(cfg.seed + 2)
    model = _seeded_model(cfg, gen).to("cuda")
    # local tokens at twice the patch, region tokens at 4 times that
    _, grids = lrg_stage_grids(cfg.vol_size3(), tuple(
        2 * p for p in cfg.patch_size3()), 4, len(cfg.depths))
    tokens = sum(int(np.prod(g)) for g in grids[0]) + 1
    vol = torch.randn(PREDICT_BATCH, *cfg.vol_size3(), 1, generator=gen)
    xb = (vol.to("cuda"), torch.full((PREDICT_BATCH, 3), 0.5, device="cuda"),
          torch.ones(PREDICT_BATCH, 3, device="cuda"))
    with torch.inference_mode():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        got = model(xb)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = _read_launches()
        _require(not any(launches.values()), f"zoo_rest LRGFormerUNETR "
                 f"vol {LRG_BIG_VOL}: launches {launches}")
        _require(tuple(got.shape) == (PREDICT_BATCH, *cfg.vol_size3(), 14)
                 and bool(torch.isfinite(got).all()),
                 f"zoo_rest LRGFormerUNETR vol {LRG_BIG_VOL}: logits")
        ms = _time_ms(lambda: model(xb), 1)
        ref = copy.deepcopy(model)
        ref.dtype = torch.float32
        with _no_tf32():
            want = torch.cat([ref(tuple(t[i:i + 4] for t in xb))
                              for i in range(0, PREDICT_BATCH, 4)])
        del ref
        rel = float((got - want).norm() / want.norm())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"zoo_rest: LRGFormerUNETR at vol {LRG_BIG_VOL} ({tokens} tokens a "
          f"window at stage 1), one predictor call of {PREDICT_BATCH} windows: "
          f"{ms:.1f} ms, peak device memory {peak / 2 ** 30:.2f} GiB; bf16 vs "
          f"fp32 on the card (TF32 off): rel norm err {rel:.3e} (tol "
          f"{MODEL_REL_TOL}), argmax agreement {agree:.4f}", flush=True)
    _require(rel <= MODEL_REL_TOL, f"zoo_rest LRGFormerUNETR vol "
             f"{LRG_BIG_VOL}: bf16 logits disagree with fp32")
    del model, got, want, xb
    torch.cuda.empty_cache()
    return launches


def _swin2d_check():
    """Swin2D through build_model (the CLIs feed 3D volumes only, in both
    packages): a forward and a gradient (DropPath draws seeded alike) of 16
    images of 384^2 in bf16 against the same weights in fp32 on the card,
    TF32 off; the forward's and the step's ms and peak memory."""
    import copy

    import torch
    import torch.nn.functional as F

    from medicalsemseg_tpu_torch.config import get_args

    cfg = get_args(SWIN2D_ARGS)
    gen = torch.Generator().manual_seed(cfg.seed + 3)
    model = _seeded_model(cfg, gen).to("cuda")
    n, edge = PREDICT_BATCH, cfg.vol_size3()[0]
    batch = {"image": torch.randn(n, edge, edge, 1, generator=gen).to("cuda"),
             "label": torch.randint(0, cfg.output_dim, (n, edge, edge),
                                    generator=gen).to("cuda"),
             "crop_loc": torch.zeros(n, 2, device="cuda"),
             "affine": torch.ones(n, 2, device="cuda")}
    x_in = (batch["image"], batch["crop_loc"], batch["affine"])

    def loss_fn(logits, label):
        return F.cross_entropy(logits.permute(0, 3, 1, 2), label)

    ref = copy.deepcopy(model)      # outside inference mode: it trains too
    ref.backbone.dtype = torch.float32
    with torch.inference_mode():
        _reset_launches()
        got = model.eval()(x_in)
        _require(not any(_read_launches().values()), "zoo_rest Swin2D: a "
                 "kernel launched")
        _require(tuple(got.shape) == (n, edge, edge, cfg.output_dim)
                 and bool(torch.isfinite(got).all()), "zoo_rest Swin2D: "
                 "logits")
        fwd_ms = _time_ms(lambda: model(x_in), 3)
        with _no_tf32():
            want = ref.eval()(x_in)
        rel = float((got - want).norm() / want.norm())
        del got, want
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = _grads_of(model, loss_fn, batch)
    peak = torch.cuda.max_memory_allocated()
    step_ms = _time_ms(lambda: _grads_of(model, loss_fn, batch), 2)
    with _no_tf32():
        want_loss, want_grads = _grads_of(ref, loss_fn, batch)
    grel = _rel_norm(grads, want_grads)
    print(f"zoo_rest: Swin2D, {n} images of {edge}^2, patch 2, window 6, "
          f"bf16 vs fp32 on the card (TF32 off): logits rel norm err "
          f"{rel:.3e} (tol {MODEL_REL_TOL}); loss {loss:.5f} / {want_loss:.5f},"
          f" whole gradient rel norm err {grel:.3e} (tol {TRAIN_GRAD_REL_TOL});"
          f" forward {fwd_ms:.1f} ms, forward and backward {step_ms:.1f} ms, "
          f"peak device memory {peak / 2 ** 30:.2f} GiB", flush=True)
    _require(rel <= MODEL_REL_TOL, "zoo_rest Swin2D: bf16 logits disagree "
             "with fp32")
    _require(grel <= TRAIN_GRAD_REL_TOL, "zoo_rest Swin2D: bf16 gradients "
             "disagree with fp32")
    del model, ref, grads, want_grads
    torch.cuda.empty_cache()


def phase_zoo_rest():
    """FocalNetUNETR and UNETR_Official at 96^3 and LRGFormerUNETR at 64^3,
    full width: one window bf16 card vs fp32 CPU and one predictor call of
    16 windows with every K2 launch held against its plain version, the
    prediction CLI, 4 training steps at batch 8, the whole gradient of a
    batch-2 step and the training CLI; LRGFormerUNETR's predictor call at
    vol 128 against fp32 on the card; Swin2D's forward and gradient."""
    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.config import get_args

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    t0 = time.perf_counter()
    for name in ZOO_REST_MODELS:
        cfg = get_args(_zoo_rest_args(name))
        gen = torch.Generator().manual_seed(cfg.seed + 4)
        vol = torch.randn(1, *cfg.vol_size3(), 1, generator=gen)
        x_in = (vol, torch.full((1, 3), 0.5), torch.ones(1, 3))
        xb = tuple(torch.cat([t] * PREDICT_BATCH) for t in x_in)
        add(_model_vs_cpu(f"zoo_rest: {name}", cfg, ZOO_REST_CALL[name],
                          x_in, xb, held=True)[0])
    add(_lrg_big_call())
    _swin2d_check()
    print(f"zoo_rest: prediction: {time.perf_counter() - t0:.1f} s",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        add(_zoo_rest_predict_cli(tmp))
        print(f"zoo_rest: the prediction CLI: {time.perf_counter() - t0:.1f} "
              "s", flush=True)
        _write_train_set(os.path.join(tmp, "Task03_ZooTrain"),
                         ZOO_CLI_VOLUMES, (128, 120, 100), 14,
                         np.random.default_rng(3))
        for name in ZOO_REST_MODELS:
            t0 = time.perf_counter()
            add(_zoo_rest_train(name, tmp))
            print(f"zoo_rest: {name} training: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    return total


def _depthwise_times():
    """FocalNet's depthwise focal layers at stage 1 of a predictor call (16
    x 48^3 x 48, kernels 6^3 and 8^3, flax's "SAME" padding, bf16): the
    port's route (the contiguous layout: PyTorch's own depthwise kernel,
    copies and the pad included) against the channels-last view (cuDNN),
    forward, and forward + backward at batch 8. Printed only: the library's
    kernels, no kernel of the port's."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(18)
    c = 48
    for k in FOCAL_KERNELS:
        pad = ((k - 1) // 2, k // 2) * 3
        w = (torch.randn(c, 1, k, k, k, generator=gen, device="cuda")
             * k ** -1.5).to(torch.bfloat16)
        for batch, train in ((PREDICT_BATCH, False), (TRAIN_BATCH, True)):
            x = torch.randn(batch, 48, 48, 48, c, generator=gen,
                            device="cuda").to(torch.bfloat16)
            if train:
                x.requires_grad_(True)
                w.requires_grad_(True)
            xn = x.permute(0, 4, 1, 2, 3)

            def contiguous():
                return F.conv3d(F.pad(xn.contiguous(), pad), w, groups=c)

            def channels_last():
                xp = F.pad(xn, pad).contiguous(
                    memory_format=torch.channels_last_3d)
                return F.conv3d(xp, w.contiguous(
                    memory_format=torch.channels_last_3d), groups=c)

            a, b = contiguous(), channels_last()
            err = float((a.float() - b.float()).abs().max().detach())
            if train:
                dy = torch.randn_like(a)
                torch.autograd.grad(b, (x, w), dy)

                def step(fn):
                    return lambda: torch.autograd.grad(fn(), (x, w), dy)

                # cuDNN's backward takes seconds here: timed once (the
                # comparison before it was the warm-up)
                times = [_time_ms(step(contiguous), 3),
                         _time_once_ms(step(channels_last))]
            else:
                with torch.inference_mode():
                    times = [_time_ms(fn, 5)
                             for fn in (contiguous, channels_last)]
            print(f"  depthwise {k}^3 conv, {batch} x 48^3 x {c}, bf16, "
                  f"{'forward + backward' if train else 'forward'}: "
                  f"contiguous (PyTorch's depthwise kernel) {times[0]:.3f} ms, "
                  f"channels-last (cuDNN) {times[1]:.3f} ms; max abs diff "
                  f"{err:.3e}", flush=True)
            del x, xn, a, b
            w = w.detach()
            torch.cuda.empty_cache()


def _zoo_rest_kernels(rep):
    """K2 at ViT-B's shape in UNETR_Official's predictor call, (M, C, H) =
    (16 x 216, 768, 3072) with LN2 absorbed and the shortcut inside, in bf16
    (the tensor-core route) and fp32 (the CUDA-core route), against its
    plain version at KERNEL_ATOL (fp32: FP32_KERNEL_TOL), a rerun
    bit-equal, timed beside its bound and the composition layer_norm ->
    linear -> gelu -> linear; then FocalNet's depthwise convs
    (``_depthwise_times``)."""
    import torch

    from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp

    gen = torch.Generator(device="cuda").manual_seed(19)
    k2 = rep["fused_mlp"]
    c, grid = 768, WS
    with torch.inference_mode():
        for dtype, route, peak in ((torch.bfloat16, "tensor_core", None),
                                   (torch.float32, "cuda_core",
                                    PEAK_FP32_FLOPS)):
            x, a, kw = _mlp_case(gen, PREDICT_BATCH, grid, c, True, True,
                                 dtype=dtype)
            m = x.shape[0]
            _require(kmlp.mlp_route(dtype, c, c, 4 * c) == route,
                     f"K2 ViT-B {dtype}: not the {route} route")
            got = kmlp.fused_mlp(x, **a, **kw)
            want = kmlp.fused_mlp_plain(x, **a, **kw)
            torch.cuda.synchronize()
            _compare(f"K2 ViT-B {route} {dtype} M={m}, C={c}, hidden 4C, "
                     "ln+res True", got, want, k2,
                     KERNEL_ATOL if peak is None else FP32_KERNEL_TOL)
            _require(torch.equal(got, kmlp.fused_mlp(x, **a, **kw)),
                     f"K2 ViT-B {dtype}: a rerun differs")
            del got, want
            elem = x.element_size()
            _stage_report(
                k2, f"vit_b_{'bf16' if peak is None else 'fp32'}", c,
                PREDICT_BATCH,
                _time_ms(lambda: kmlp.fused_mlp(x, **a, **kw), 10),
                _time_ms(lambda: kmlp.fused_mlp_plain(x, **a, **kw), 10),
                16 * m * c * c, 2 * m * c * elem + 8 * c * c * elem
                + 5 * c * 4 + 2 * c * 4, peak,
                extra=_mlp_reference(x, a, kw))
            k2["per_stage"][-1]["M"] = m
            del x, a, kw
            torch.cuda.empty_cache()
    _depthwise_times()


# the one-pass CUDA-core heads forms' head dims at the flagship's stage
# shapes: hidden 48 with heads 3 6 12 24 gives 16, hidden 96 gives 32
FORMS_HIDDEN = (48, 96)


class _heads_form:
    """Inside the block the wrappers of K1, K6 and K3 pick the form of
    their CUDA-core heads launches from ``one_pass``, the largest head dim
    of the one-pass form (the wide form above it): 32 for the one-pass form
    wherever it runs, 0 for the wide form everywhere."""

    def __init__(self, one_pass):
        self.one_pass = one_pass

    def __enter__(self):
        from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

        self.saved = (kwa.NARROW_HEAD_DIM, kwa.BWD_NARROW_HEAD_DIM)
        kwa.NARROW_HEAD_DIM = kwa.BWD_NARROW_HEAD_DIM = self.one_pass

    def __exit__(self, *exc):
        from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

        kwa.NARROW_HEAD_DIM, kwa.BWD_NARROW_HEAD_DIM = self.saved


def phase_heads_forms():
    """The CUDA-core heads launches of K1, K6 and K3 in their two forms, the
    one-pass form (a block a window and head, its tiles in shared memory, a
    lane a channel) and the wide form (a block a head and a run of windows,
    q, k, v in a scratch buffer, the head dim in chunks of 32), at head dims
    16 and 32, where both run: batch 2 at the four flagship stages of
    hidden 48 and 96, bf16 and fp32 on the CUDA-core route. Each form is
    held against plain, then each whole call timed in each form (the heads
    launch is what differs), one-pass, wide, one-pass, wide: the smaller of
    each form's two times. These readings set NARROW_HEAD_DIM and
    BWD_NARROW_HEAD_DIM (ops/kernels/window_attention.py)."""
    import torch

    from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
    from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

    gen = torch.Generator(device="cuda").manual_seed(13)
    forms = (("one-pass", lambda: _heads_form(32)),
             ("wide", lambda: _heads_form(0)))
    with torch.inference_mode():
        for dt in (torch.bfloat16, torch.float32):
            fp32 = dt == torch.float32
            tol = FP32_KERNEL_TOL if fp32 else KERNEL_ATOL
            gtol = ((FP32_GRAD_NORM_TOL, FP32_GRAD_MAX_TOL) if fp32
                    else (None, None))
            for hidden in FORMS_HIDDEN:
                for grid, c0, nh in STAGES:
                    c = c0 * hidden // 48
                    wins, a, kw = _attn_case(gen, R15_BATCH, grid, c, nh, 0,
                                             True, True, dt)
                    dy = torch.randn(wins.shape, generator=gen,
                                     device="cuda").to(dt)
                    b = {k: v for k, v in a.items() if k != "bproj"}
                    gwins, ga, gkw = _global_case(gen, R15_BATCH, grid, c,
                                                  nh, True, False, dt)
                    calls = {
                        "K1": lambda: kwa.window_attention(
                            wins, **a, **kw, route="cuda_core"),
                        "K6": lambda: kga.global_window_attention(
                            gwins, **ga, **gkw, route="cuda_core"),
                        "K3": lambda: kwa.window_attention_bwd(
                            wins, dy=dy, **b, **kw, route="cuda_core")}
                    case = (f"{'fp32' if fp32 else 'bf16'} hidden {hidden} "
                            f"grid {grid}^3 x{R15_BATCH}, C={c}, head dim "
                            f"{c // nh}")
                    want = {
                        "K1": kwa.window_attention_plain(wins, **a, **kw),
                        "K6": kga.global_window_attention_plain(
                            gwins, **ga, **gkw),
                        "K3": kwa.window_attention_bwd_plain(
                            wins, dy=dy, **b, **kw)}
                    for form, ctx in forms:
                        with ctx():
                            for k, fn in calls.items():
                                label = f"heads_forms: {k} {form} {case}"
                                if k == "K3":
                                    _compare_grads(label, K3_NAMES, fn(),
                                                   want[k], {}, *gtol)
                                else:
                                    _compare(label, fn(), want[k], {}, tol)
                    ms = {(k, f): [] for k in calls for f, _ in forms}
                    for _ in range(2):
                        for form, ctx in forms:
                            with ctx():
                                for k, fn in calls.items():
                                    ms[k, form].append(_time_ms(fn, 3))
                    for k in calls:
                        one, wide = (min(ms[k, f]) for f, _ in forms)
                        print(f"heads_forms: {k} {case}: one-pass "
                              f"{one:.3f} ms, wide {wide:.3f} ms "
                              f"(wide / one-pass {wide / one:.2f})",
                              flush=True)
                    del wins, a, b, kw, dy, gwins, ga, gkw, want
                    torch.cuda.empty_cache()


# ---- the sixteenth slice: data parallelism, --profile_dir and the
# device-resident data pipeline

DIST_BATCH = 4        # the global batch of the data-parallel step: 2 a rank
DIST_LR = 1e-4
# no DropPath: a rank's draws for its 2 crops are not the one process's for 4
DIST_ARGS = ["--lr", str(DIST_LR), "--drop_path_rate", "0"]
# The two-rank step against one process on the same 4 crops, bf16, the same
# weights. Every crop's forward and backward is the same computation in
# both; the batch sums of the weight gradients run in another order (two
# halves, then the all_reduce), and cuBLAS / cuDNN may pick other
# algorithms at batch 2 than at 4, so the loss and the gradient norm differ
# by fp32 accumulation noise: 1.5e-6 and 1.3e-6 relative on an NVIDIA H100
# 80GB HBM3 at 700 W; the limit leaves room for the order of atomic adds.
DIST_LOSS_RTOL = 1e-4
DIST_GRAD_NORM_RTOL = 1e-4
# The first AdamW update moves a parameter by lr * g / (|g| + 1e-6): where
# |g| is near the epsilon (deep layers at seeded weights), noise in g moves
# the update by a share of lr. The mean over all parameters of |difference|
# / lr was 0.047 (0.0003 % of the elements over 1 lr); about 2.5 times that.
DIST_PARAM_MEAN_LR = 0.12
# K5's auto window is open at 2 x 96^3 voxels: 3 launches a micro-step
DIST_K5_A_STEP = 3


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(cmd, world, backend=None, timeout=600, extra_env=None):
    """Run ``cmd`` as ``world`` ranks on the one card (torchrun's variables,
    LOCAL_RANK 0 for every rank); returns [(exit code, output)]. A rank
    still running at ``timeout`` seconds is killed."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=REPO,
                   **(extra_env or {}))
        env.pop("MEDSEG_DIST_BACKEND", None)
        if backend:
            env["MEDSEG_DIST_BACKEND"] = backend
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    deadline = time.time() + timeout
    try:
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(deadline - time.time(), 1))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n[killed at the timeout]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _child_cmd(kind, tmp):
    return [sys.executable, os.path.abspath(__file__), "--dist_child", kind,
            "--dist_dir", tmp]


def dist_child(kind, tmp):
    """One rank of the dist phase (a child process of this script, or this
    process as the one rank of a world of one): ``ddp`` (the data-parallel
    flagship step on this rank's share of the batch), ``pair`` (one
    all_reduce, to see what the backend does with two ranks on one card).
    Writes its results to ``tmp``."""
    import torch
    import torch.distributed as dist

    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.parallel import dist as pdist
    from medicalsemseg_tpu_torch.parallel.mesh import shard_batch
    from medicalsemseg_tpu_torch.train.state import distribute

    dev = pdist.init_distributed_mode(get_args(TRAIN_ARGS),
                                      torch.device("cuda"))
    rank, world = pdist.get_rank(), pdist.get_world_size()
    res = {"rank": rank, "world": world, "backend": dist.get_backend()}
    if kind == "pair":
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        res["sum"] = t[0].item()
    else:
        _, _, state, step = _train_setup(DIST_ARGS)
        state = distribute(state, dist.group.WORLD)
        batch = {k: v.to(dev) for k, v in torch.load(
            os.path.join(tmp, "batch.pt"), weights_only=True).items()}
        mine = shard_batch(batch, rank, world)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        m = step(state, mine)
        torch.cuda.synchronize()
        res["launches"] = _read_launches()
        res["loss"], res["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
        if rank == 0:
            torch.save({k: v.float().cpu()
                        for k, v in state.model.state_dict().items()},
                       os.path.join(tmp, f"params_{kind}_{world}.pt"))
        res["ms"] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, mine)
            torch.cuda.synchronize()
            res["ms"].append(1e3 * (time.perf_counter() - t0))
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    with open(os.path.join(tmp, f"{kind}_{world}_{rank}.json"), "w") as f:
        json.dump(res, f)
    pdist.shutdown()


def _ranks_ok(what, runs):
    for r, (rc, out) in enumerate(runs):
        _require(rc == 0, f"dist: {what} rank {r} exited {rc}:\n"
                 f"{out[-3000:]}")


_CLI_PREDS = {}     # the cli phase's flagship labels, by volume


def _write_cli_set(tmp):
    """The cli phase's two CT volumes (same seed) under Task01_SmokeCT."""
    import numpy as np

    from medicalsemseg_tpu_torch.data import nifti

    os.makedirs(os.path.join(tmp, "Task01_SmokeCT", "imagesTs"))
    with open(os.path.join(tmp, "Task01_SmokeCT", "dataset.json"), "w") as f:
        json.dump({"training": [], "test": [
            f"./imagesTs/img{i}.nii.gz" for i in (0, 1)]}, f)
    rng = np.random.default_rng(0)
    for i, shape in enumerate(CLI_SHAPES):
        nifti.save(nifti.NiftiImage(_ct_volume(rng, shape),
                                    np.diag([0.8, 0.8, 2.5, 1.0])),
                   os.path.join(tmp, "Task01_SmokeCT", "imagesTs",
                                f"img{i}.nii.gz"))


def phase_dist():
    """Data parallelism on the one card. The full-width flagship's step on
    a global batch of 4 crops (bf16) by two ranks (child processes, gloo on
    CUDA tensors, DDP, 2 crops a rank) against one process on the same
    crops: loss, grad norm and parameters after the update. What NCCL does
    with two ranks on one card; the same step by one NCCL rank through DDP.
    Then the prediction CLI at world size 2 on the cli phase's two volumes:
    its labels against the one-process run's."""
    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.cli import run_test
    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.data import nifti

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        gen = torch.Generator(device="cuda").manual_seed(7)
        batch = _train_batch(gen, DIST_BATCH, 14)
        torch.save({k: v.cpu() for k, v in batch.items()},
                   os.path.join(tmp, "batch.pt"))
        _, _, state, step = _train_setup(DIST_ARGS)
        _reset_launches()
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        one_ms = 1e3 * (time.perf_counter() - t0)
        add(_read_launches())
        want = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        want_p = {k: v.float().cpu() for k, v in
                  state.model.state_dict().items()}
        del state, step, m, batch
        torch.cuda.empty_cache()
        print(f"dist: one process, batch {DIST_BATCH}: loss "
              f"{want['loss']:.6f}, grad norm {want['grad_norm']:.6f} "
              f"({one_ms:.0f} ms with the first call's set-up)", flush=True)

        def held(tag, world):
            res = [json.load(open(os.path.join(tmp, f"ddp_{world}_{r}.json")))
                   for r in range(world)]
            got_p = torch.load(os.path.join(tmp, f"params_ddp_{world}.pt"),
                               weights_only=True)
            diff = torch.cat([(got_p[k] - want_p[k]).abs().flatten()
                              for k in want_p])
            loss_rel = max(abs(r["loss"] - want["loss"]) / want["loss"]
                           for r in res)
            gn_rel = max(abs(r["grad_norm"] - want["grad_norm"])
                         / want["grad_norm"] for r in res)
            mean_lr = float(diff.mean()) / DIST_LR
            print(f"dist: {tag}: loss rel err {loss_rel:.3e} (tol "
                  f"{DIST_LOSS_RTOL}), grad norm rel err {gn_rel:.3e} (tol "
                  f"{DIST_GRAD_NORM_RTOL}), parameters after the update: "
                  f"largest |diff| {float(diff.max()):.3e} "
                  f"({float(diff.max()) / DIST_LR:.2f} lr), mean |diff| "
                  f"{mean_lr:.4f} lr (tol {DIST_PARAM_MEAN_LR}), "
                  f"{int((diff > DIST_LR).sum())} of {diff.numel()} over "
                  f"1 lr", flush=True)
            for r in res:
                print(f"dist: {tag} rank {r['rank']} ({r['backend']}): "
                      f"loss {r['loss']:.6f}, grad norm "
                      f"{r['grad_norm']:.6f}, peak device memory "
                      f"{r['peak_gib']:.2f} GiB, ms per step "
                      f"{[round(t, 1) for t in r['ms']]} (the ranks share "
                      f"the card), launches "
                      f"{ {k: v for k, v in r['launches'].items() if v} }",
                      flush=True)
                add(r["launches"])
                _require_launches(f"dist {tag} rank {r['rank']}",
                                  r["launches"], {
                                      **_swin_step_launches(8),
                                      "dw27": DIST_K5_A_STEP})
            _require(loss_rel <= DIST_LOSS_RTOL and gn_rel <= DIST_GRAD_NORM_RTOL
                     and mean_lr <= DIST_PARAM_MEAN_LR,
                     f"dist: {tag} disagrees with the one-process step")

        t0 = time.perf_counter()
        runs = _spawn_ranks(_child_cmd("ddp", tmp), 2, backend="gloo")
        _ranks_ok("DDP step (gloo)", runs)
        held("2 ranks, gloo, 2 crops a rank", 2)
        print(f"dist: 2-rank step run {time.perf_counter() - t0:.1f} s",
              flush=True)

        runs = _spawn_ranks(_child_cmd("pair", tmp), 2, backend="nccl",
                            timeout=120)
        if all(rc == 0 for rc, _ in runs):
            sums = [json.load(open(os.path.join(tmp, f"pair_2_{r}.json")))[
                "sum"] for r in range(2)]
            print(f"dist: NCCL with two ranks on one card ran an all_reduce "
                  f"(sums {sums})", flush=True)
        else:
            lines = [ln for _, out in runs for ln in out.splitlines()
                     if "rror" in ln or "uplicate" in ln]
            print(f"dist: NCCL with two ranks on one card refused: exit "
                  f"codes {[rc for rc, _ in runs]}; "
                  f"{lines[-1].strip()[:300] if lines else runs[0][1][-300:]}",
                  flush=True)

        # one NCCL rank, in this process (it leaves the group after)
        env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
        saved_env = {k: os.environ.get(k)
                     for k in (*env, "MEDSEG_DIST_BACKEND")}
        os.environ.update(env)
        os.environ.pop("MEDSEG_DIST_BACKEND", None)
        try:
            dist_child("ddp", tmp)
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        torch.cuda.empty_cache()
        held("1 rank, nccl, 4 crops", 1)

        # volume-parallel prediction: one volume a rank
        if not _CLI_PREDS:
            _write_cli_set(tmp)
            run_test.main(get_args(FLAGSHIP_ARGS + [
                "--data_path", tmp, "--task", "Task01_SmokeCT",
                "--output_dir", os.path.join(tmp, "w1"), "--device", "cuda"]))
            for i in (0, 1):
                _CLI_PREDS[i] = nifti.load(os.path.join(
                    tmp, "w1", "test_output", "Fold0", "pred",
                    f"{i}.nii.gz")).data
        elif not os.path.isdir(os.path.join(tmp, "Task01_SmokeCT")):
            _write_cli_set(tmp)
        t0 = time.perf_counter()
        runs = _spawn_ranks(
            [sys.executable, "-m", "medicalsemseg_tpu_torch.cli.run_test",
             *FLAGSHIP_ARGS, "--data_path", tmp, "--task", "Task01_SmokeCT",
             "--output_dir", os.path.join(tmp, "w2"), "--device", "cuda"],
            2, backend="gloo")
        _ranks_ok("run_test at world size 2", runs)
        wall = time.perf_counter() - t0
        differ = {}
        for i in (0, 1):
            got = nifti.load(os.path.join(tmp, "w2", "test_output", "Fold0",
                                          "pred", f"{i}.nii.gz")).data
            _require(got.shape == _CLI_PREDS[i].shape,
                     f"dist: run_test world 2 volume {i} shape {got.shape}")
            differ[i] = int((got != _CLI_PREDS[i]).sum())
        per_rank = [[ln.split(":")[0] for ln in out.splitlines()
                     if "predicted in" in ln] for _, out in runs]
        print(f"dist: run_test at world size 2 (gloo): volumes by rank "
              f"{per_rank}, {wall:.1f} s with the ranks' start; voxels whose "
              f"label differs from the one-process run: {differ} of "
              f"{ {i: int(np.prod(p.shape)) for i, p in _CLI_PREDS.items()} }",
              flush=True)
        _require(sorted(sum(per_rank, [])) == ["0.nii.gz", "1.nii.gz"],
                 f"dist: run_test ranks predicted {per_rank}")
        _require(not any(differ.values()), "dist: the labels of the "
                 "volume-parallel run differ from the one-process run's")
    return total


PIPE_VOLUMES = 5      # fold 0 of 5: 4 train volumes, 1 validation volume
PIPE_SHAPE = (128, 120, 100)
PIPE_BATCH = 2        # 2 steps an epoch
# K1-K4 under the names of their kernels in a trace (their tensor-core
# routes, which bf16 takes at the flagship's widths)
TRACE_KERNELS = {"window_attention": "window_attention_heads_tc",
                 "fused_mlp": "fused_mlp_tc",
                 "window_attention_bwd": "window_attention_bwd_heads_tc",
                 "fused_mlp_bwd": "fused_mlp_bwd_w_tc"}


def _pipe_args(tmp, *extra):
    return TRAIN_ARGS + [
        "--data_path", tmp, "--task", "Task05_SmokePipe", "--t_spatial_pad",
        "--t_fixed_ct_intensity", "--t_rand_crop_fgbg", "--n_images_per_batch",
        str(PIPE_BATCH), "--metric_readback_freq", "1", *extra]


def phase_profile_dir():
    """One epoch of two steps (the flagship at batch 2) through the training
    CLI with --profile_dir: the trace file exists and holds the kernels of
    K1-K4 among its events, and device_memory_stats() reports a peak."""
    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.cli import run_training
    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.utils.profiling import device_memory_stats

    with tempfile.TemporaryDirectory() as tmp:
        _write_train_set(os.path.join(tmp, "Task05_SmokePipe"), PIPE_VOLUMES,
                         PIPE_SHAPE, 14, np.random.default_rng(5))
        prof = os.path.join(tmp, "prof")
        _reset_launches()
        t0 = time.perf_counter()
        run_training.main(get_args(_pipe_args(
            tmp, "--epochs", "1", "--val_interval", "2", "--profile_dir",
            prof)))
        wall = time.perf_counter() - t0
        launches = _read_launches()
        path = os.path.join(prof, "trace_rank0.json")
        _require(os.path.exists(path), f"profile_dir: no {path}")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        found = {k: sum(name in e.get("name", "") for e in kernels)
                 for k, name in TRACE_KERNELS.items()}
        stats = device_memory_stats()
        peak = max((s["peak_bytes_in_use"] for s in stats.values()), default=0)
        print(f"profile_dir: 1 epoch of 2 steps at batch {PIPE_BATCH} in "
              f"{wall:.1f} s with the trace; {path}: {size / 2 ** 20:.1f} MiB, "
              f"{len(events)} events, {len(kernels)} kernel events; the "
              f"kernels of K1-K4 by name {found}; device_memory_stats "
              f"{stats}; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        _require(all(found.values()), f"profile_dir: a kernel of K1-K4 is "
                 f"not in the trace: {found}")
        _require(peak > 0, f"profile_dir: device_memory_stats {stats}")
        _require_launches("profile_dir (2 steps)", launches, {
            "window_attention_bwd": 16, "fused_mlp_bwd": 16})
        # the forward kernels: twice a block and step, and the validation's
        _require(min(launches["window_attention"], launches["fused_mlp"])
                 >= REMAT_FORWARDS * 16, f"profile_dir: launches {launches}")
    return launches


def phase_device_pipeline():
    """The device-resident crop pipeline: its first batch on the card equals
    the same loader's on the CPU (the crops, flips, rot90 and intensity
    change exactly, and within 1e-6 after channel normalisation); then two
    epochs through the training CLI with --device_data_pipeline."""
    import numpy as np
    import torch

    from medicalsemseg_tpu_torch.cli import run_training
    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.data.dataset import CachedVolumeDataset
    from medicalsemseg_tpu_torch.data.datalist import build_cv_file_lists
    from medicalsemseg_tpu_torch.data.device_pipeline import (
        DeviceCachedDataset,
        DeviceTrainLoader,
    )

    with tempfile.TemporaryDirectory() as tmp:
        _write_train_set(os.path.join(tmp, "Task05_SmokePipe"), PIPE_VOLUMES,
                         PIPE_SHAPE, 14, np.random.default_rng(6))
        aug = ["--t_flip_prob", "0.5", "--t_rot_prob", "0.5",
               "--t_intensity_shift_prob", "0.5",
               "--t_intensity_scale_prob", "0.5"]
        for norm, tol in (([], 0.0), (["--t_normalize",
                                       "--t_normalize_channel_wise"], 1e-6)):
            cfg = get_args(_pipe_args(tmp, *aug, *norm))
            host = CachedVolumeDataset(build_cv_file_lists(cfg)[0], cfg,
                                       mode="train")
            first = {}
            for dev in ("cuda", "cpu"):
                t0 = time.perf_counter()
                ds = DeviceCachedDataset(host, cfg, torch.device(dev))
                torch.cuda.synchronize()
                cached = time.perf_counter() - t0
                t0 = time.perf_counter()
                first[dev] = next(iter(DeviceTrainLoader(ds, cfg, seed=3)
                                       .epoch(0)))
                torch.cuda.synchronize()
                print(f"device_pipeline: {dev}: {len(ds)} volumes cached in "
                      f"{cached:.2f} s, the first batch of "
                      f"{tuple(first[dev]['image'].shape)} in "
                      f"{1e3 * (time.perf_counter() - t0):.1f} ms", flush=True)
                del ds
            errs = {k: float((first["cuda"][k].cpu().double()
                              - first["cpu"][k].double()).abs().max())
                    for k in first["cpu"]}
            print(f"device_pipeline: {'channel normalisation' if norm else 'no normalisation'}: "
                  f"largest |card - CPU| {errs} (tol {tol} for the image, "
                  f"0 for the rest)", flush=True)
            _require(errs["image"] <= tol and errs["label"] == 0
                     and errs["crop_loc"] == 0 and errs["affine"] == 0,
                     "device_pipeline: the card's first batch differs from "
                     "the CPU's")
        torch.cuda.empty_cache()

        out = os.path.join(tmp, "out")
        os.makedirs(out)
        _reset_launches()
        t0 = time.perf_counter()
        run_training.main(get_args(_pipe_args(
            tmp, *aug, "--t_normalize", "--t_normalize_channel_wise",
            "--device_data_pipeline", "--epochs", "2", "--val_interval", "2",
            "--output_dir", out)))
        wall = time.perf_counter() - t0
        launches = _read_launches()
        with open(os.path.join(out, "log.txt")) as f:
            rows = [json.loads(line) for line in f]
        _require([r["epoch"] for r in rows] == [0, 1]
                 and all(np.isfinite(r["train/loss"]) for r in rows)
                 and np.isfinite(rows[-1]["val/loss"]),
                 f"device_pipeline: log.txt {rows}")
        print(f"device_pipeline: 2 epochs of 2 steps at batch {PIPE_BATCH} "
              f"with --device_data_pipeline and a validation in {wall:.1f} "
              f"s, losses {[round(r['train/loss'], 4) for r in rows]}, "
              f"launches { {k: v for k, v in launches.items() if v} }",
              flush=True)
        _require_launches("device_pipeline (4 steps)", launches, {
            "window_attention_bwd": 32, "fused_mlp_bwd": 32})
        _require(min(launches["window_attention"], launches["fused_mlp"])
                 >= REMAT_FORWARDS * 32,
                 f"device_pipeline: launches {launches}")
    return launches


# --remat: the flagship at batch 8 under each mode; each parameter's
# gradient under a mode against "none"'s within twice the spread of two
# "none" runs (K3's index_add_ atomics make the card's backward not
# bit-exact), and never under this relative L2 floor
REMAT_GRAD_FLOOR = 1e-5
REMAT_LOSS_RTOL = 1e-6
REMAT_TIMED_STEPS = 3
REMAT_BIG_BATCH = 16
REMAT_STATS_BATCH = 2
# SwInception's BatchNorm running statistics after one step under "conv"
# against "none": the same forward, the recompute moves nothing
REMAT_STATS_RTOL = 1e-6
# MEDSEG_WINOGRAD=1 in fp32: the 3^3 convs without TF32, against the
# library's default (TF32 allowed), in one predictor call of two windows
FP32_WINDOWS = 2
FP32_LOGITS_RTOL = 1e-2


def _set_remat(model, mode):
    """Every rematerialising module of ``model`` (the Swin encoder's stages,
    the UNETR decoder) under ``mode``."""
    from medicalsemseg_tpu_torch.models.decoders import SwinUNETRDecoder
    from medicalsemseg_tpu_torch.models.swin import BasicLayer

    for m in model.modules():
        if isinstance(m, (BasicLayer, SwinUNETRDecoder)):
            m.remat = mode


def _remat_grads(model, loss_fn, batch, card):
    """One step's loss and gradients (same weights, batch and DropPath
    draws) under each mode, against two runs under "none"."""
    runs = {}
    for tag in ("none", "none again", "conv", "mixed", "full"):
        _set_remat(model, tag.split()[0])
        runs[tag] = _grads_of(model, loss_fn, batch)
    names = [n for n, _ in model.named_parameters()]

    def rel(a, b):
        return float((a - b).norm() / b.norm()) if bool(b.any()) else float(
            (a - b).norm())

    (l0, g0), (_, g1) = runs["none"], runs["none again"]
    spread = [rel(a, b) for a, b in zip(g1, g0)]
    print(f"remat: gradients of one step, batch {TRAIN_BATCH}, {card}: two "
          f"runs under none differ by at most {max(spread):.3e} (a "
          f"parameter's relative L2), {sum(v > 0 for v in spread)} of "
          f"{len(spread)} parameters not bit-equal", flush=True)
    for mode in ("conv", "mixed", "full"):
        lm, gm = runs[mode]
        errs = [(rel(a, b), max(2 * s, REMAT_GRAD_FLOOR), n)
                for a, b, s, n in zip(gm, g0, spread, names)]
        worst = max(errs, key=lambda e: e[0] / e[1])
        print(f"remat: {mode}: loss {lm:.7f} vs {l0:.7f}; worst gradient "
              f"{worst[2]} {worst[0]:.3e} (tol {worst[1]:.3e}); "
              f"{sum(e[0] == 0 for e in errs)} of {len(errs)} bit-equal",
              flush=True)
        _require(abs(lm - l0) <= REMAT_LOSS_RTOL * abs(l0),
                 f"remat {mode}: the loss moved")
        _require(worst[0] <= worst[1], f"remat {mode}: {worst[2]}'s gradient "
                 "differs from none's beyond the run-to-run spread")


def _remat_exact_fp32(card):
    """One fp32 predictor call of FP32_WINDOWS windows with MEDSEG_WINOGRAD=1
    (the no-gradient 3^3 convs in true fp32, as the JAX package's F(4^3,
    3^3) branch computes them in fp32) against the same call unset (TF32
    allowed, the library's default) and unset with TF32 off everywhere; the
    convs that ran without TF32 counted against the 3^3 / stride-1 convs
    that hooks see."""
    import torch

    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.ops import convgrad

    cfg = get_args(FLAGSHIP_ARGS + ["--compute_dtype", "float32"])
    gen = torch.Generator().manual_seed(cfg.seed)
    model = _seeded_model(cfg, gen).to("cuda")
    vol = torch.randn(FP32_WINDOWS, 96, 96, 96, 1, generator=gen).to("cuda")
    x_in = (vol, torch.full((FP32_WINDOWS, 3), 0.5, device="cuda"),
            torch.ones(FP32_WINDOWS, 3, device="cuda"))
    need, ran = [0], [0]
    no_tf32 = convgrad.no_tf32

    def counted():
        ran[0] += 1
        return no_tf32()

    def hook(mod, args, out):
        need[0] += 1

    with torch.inference_mode():
        hooks = [m.register_forward_hook(hook) for m in model.modules()
                 if _is_conv3_s1(m)]
        with _gates():
            base = model(x_in)
        for h in hooks:
            h.remove()
        convgrad.no_tf32 = counted
        try:
            with _gates("MEDSEG_WINOGRAD"):
                got = model(x_in)
                torch.cuda.synchronize()
        finally:
            convgrad.no_tf32 = no_tf32

        def call_ms(on):
            with _gates(*(("MEDSEG_WINOGRAD",) if on else ())):
                return _time_ms(lambda: model(x_in), 2)

        t = [call_ms(on) for on in (True, False, False, True)]
        with _no_tf32(), _gates():      # every conv and product in fp32
            exact = model(x_in)
            t_fp32 = _time_ms(lambda: model(x_in), 2)
    rel = float((got - base).norm() / base.norm())
    rel_fp32 = float((got - exact).norm() / exact.norm())
    print(f"remat: fp32 predictor call of {FP32_WINDOWS} windows, {card}: "
          f"MEDSEG_WINOGRAD=1 ran {ran[0]} convs without TF32 (of "
          f"{need[0]} 3^3 / stride-1 convs); logits vs unset rel norm err "
          f"{rel:.3e} (tol {FP32_LOGITS_RTOL}), vs TF32 off everywhere "
          f"{rel_fp32:.3e}; ms =1 {t[0]:.1f}, unset {t[1]:.1f}, unset "
          f"{t[2]:.1f}, =1 {t[3]:.1f}, TF32 off everywhere {t_fp32:.1f}",
          flush=True)
    _require(ran[0] == need[0] > 0, f"remat: {ran[0]} convs ran without "
             f"TF32, the gate takes {need[0]}")
    _require(bool(torch.isfinite(got).all()) and rel <= FP32_LOGITS_RTOL,
             "remat: the logits without TF32 disagree with the library's "
             "default")
    del model
    torch.cuda.empty_cache()


def phase_remat():
    """--remat on the card: the flagship at batch 8 in bf16 (drop path 0.2)
    under each mode, gradients against "none" and ms, peak memory and K1-K4
    launches by route of a step; batch 16 under "full" and "mixed";
    SwInception's running statistics under "conv"; then one fp32 predictor
    call with MEDSEG_WINOGRAD=1."""
    import statistics

    import torch

    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
    from medicalsemseg_tpu_torch.train.losses import build_loss

    card = _card_label()
    total = dict.fromkeys(_read_launches(), 0)

    def add(delta):
        for k, v in delta.items():
            total[k] += v

    cfg, model, state, train_step = _train_setup()
    _require(cfg.remat == "conv" and cfg.drop_path_rate == 0.2,
             f"remat: the defaults are --remat {cfg.remat}, drop path "
             f"{cfg.drop_path_rate}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = _train_batch(gen, TRAIN_BATCH, cfg.output_dim)
    _reset_launches()
    _remat_grads(model, build_loss(cfg), batch, card)
    add(_read_launches())

    for mode in ("none", "conv", "mixed", "full"):
        _set_remat(model, mode)
        train_step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        times = []
        for _ in range(REMAT_TIMED_STEPS):
            t0 = time.perf_counter()
            m = train_step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches, routes = _read_launches(), _read_routes()
        add(launches)
        _require(bool(torch.isfinite(m["loss"])), f"remat {mode}: loss")
        fwd = 8 * (1 if mode == "none" else REMAT_FORWARDS)
        _require_launches(f"remat {mode} ({REMAT_TIMED_STEPS} steps)",
                          launches, {
                              **dict.fromkeys(launches, 0),
                              "window_attention": fwd * REMAT_TIMED_STEPS,
                              "fused_mlp": fwd * REMAT_TIMED_STEPS,
                              "window_attention_bwd": 8 * REMAT_TIMED_STEPS,
                              "fused_mlp_bwd": 8 * REMAT_TIMED_STEPS})
        per_step = {k: {r: v // REMAT_TIMED_STEPS for r, v in routes[k].items()
                        if v} for k in SWIN_KERNELS}
        print(f"remat: --remat {mode}, batch {TRAIN_BATCH} x 96^3, bf16, "
              f"{card}: ms per step {statistics.median(times):.1f} (median "
              f"of {[round(t, 1) for t in times]}, after one warm-up), peak "
              f"device memory {peak:.2f} GiB, launches per step by route "
              f"{per_step}", flush=True)

    big = _train_batch(gen, REMAT_BIG_BATCH, cfg.output_dim)
    for mode in ("full", "mixed"):
        _set_remat(model, mode)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        times = []
        try:
            for _ in range(2):
                t0 = time.perf_counter()
                m = train_step(state, big)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        except torch.cuda.OutOfMemoryError:
            raise PhaseError(
                f"remat {mode}: batch {REMAT_BIG_BATCH} does not fit the card "
                f"(peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
                "when it ran out)") from None
        add(_read_launches())
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"remat: --remat {mode}, batch {REMAT_BIG_BATCH} x 96^3, bf16, "
              f"{card}: loss {float(m['loss']):.4f}, ms per step "
              f"{times[1]:.1f} (the first, with the library's choice of "
              f"algorithms, {times[0]:.1f}), peak device memory {peak:.2f} "
              f"GiB", flush=True)
        _require(bool(torch.isfinite(m["loss"])), f"remat {mode}: batch "
                 f"{REMAT_BIG_BATCH} loss")
    del model, state, big
    torch.cuda.empty_cache()

    # SwInception: BatchNorm inside the checkpointed Swin blocks
    cfg_s = get_args(TRAIN_ARGS + ["--model", "SwInception"])
    model_s = init_weights(build_model(cfg_s), torch.Generator().manual_seed(
        cfg_s.seed)).to("cuda")
    start = {k: v.clone() for k, v in model_s.state_dict().items()}
    small = {k: v[:REMAT_STATS_BATCH] for k, v in batch.items()}
    stats = {}
    _reset_launches()
    for mode in ("none", "conv"):
        model_s.load_state_dict(start)
        _set_remat(model_s, mode)
        _grads_of(model_s, build_loss(cfg_s), small)
        stats[mode] = {k: v.clone() for k, v in model_s.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))}
    add(_read_launches())
    worst = max(float((stats["conv"][k] - v).norm() / v.norm())
                for k, v in stats["none"].items())
    equal = all(torch.equal(stats["conv"][k], v)
                for k, v in stats["none"].items())
    moved = sum(not torch.equal(v, start[k]) for k, v in stats["none"].items())
    print(f"remat: SwInception batch {REMAT_STATS_BATCH}, one step under conv "
          f"vs none, {card}: {len(stats['none'])} running statistics "
          f"({moved} moved), bit-equal {equal}, worst rel diff {worst:.3e} "
          f"(tol {REMAT_STATS_RTOL})", flush=True)
    _require(moved == len(stats["none"]) and worst <= REMAT_STATS_RTOL,
             "remat: SwInception's running statistics under conv differ")
    del model_s, start
    torch.cuda.empty_cache()

    _remat_exact_fp32(card)
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--kernels", default=",".join(KERNEL_GROUPS),
                    help="groups of the kernels phase to run, a "
                         "comma-separated subset of " + ",".join(KERNEL_GROUPS))
    ap.add_argument("--dist_child", choices=("ddp", "pair"),
                    help=argparse.SUPPRESS)   # a rank of the dist phase
    ap.add_argument("--dist_dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    groups = args.kernels.split(",")
    if set(groups) - set(KERNEL_GROUPS):
        ap.error(f"unknown kernel groups {sorted(set(groups) - set(KERNEL_GROUPS))}")

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
    if args.dist_child:
        dist_child(args.dist_child, args.dist_dir)
        return 0

    # every phase sets the gates it means to test
    for gate in WINO_GATES + (OFFICIAL_GATE,):
        os.environ.pop(gate, None)
    kernels = []
    try:
        if "card" in phases:
            phase_card()
        if "build" in phases:
            phase_build()
        if "kernels" in phases:
            t0 = time.perf_counter()
            kernels = phase_kernels(groups)
            print(f"phase kernels: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "model" in phases:
            phase_model()
        # the main paths: each is driven with the counts at 0 and read after
        for name, phase in (("zoo", phase_zoo), ("cli", phase_cli),
                            ("train", phase_train),
                            ("train_b4", phase_train_b4),
                            ("train_cli", phase_train_cli),
                            ("fused", phase_fused),
                            ("train_wino", phase_train_wino),
                            ("conv3d", phase_conv3d),
                            ("fp32", phase_fp32), ("eval", phase_eval),
                            ("f5", phase_f5), ("r15", phase_r15),
                            ("zoo_train", phase_zoo_train),
                            ("swin_opts", phase_swin_opts),
                            ("zoo_official", phase_zoo_official),
                            ("zoo_rest", phase_zoo_rest),
                            ("dist", phase_dist),
                            ("profile_dir", phase_profile_dir),
                            ("device_pipeline", phase_device_pipeline),
                            ("remat", phase_remat)):
            if name in phases:
                t0 = time.perf_counter()
                launches = phase()
                print(f"phase {name}: {time.perf_counter() - t0:.1f} s",
                      flush=True)
                for k in kernels:
                    k[f"launches_{name}"] = launches[k["name"]]
                    k["launches"] += launches[k["name"]]
        if "profile" in phases:
            phase_profile()
        if "profile_official" in phases:
            phase_profile_official()
        if "k9_parts" in phases:
            phase_k9_parts()
        if "k5_parts" in phases:
            phase_k5_parts()
        if "k10_parts" in phases:
            phase_k10_parts()
        if "attn_parts" in phases:
            phase_attn_parts()
        if "mlp_parts" in phases:
            phase_mlp_parts()
        if "sr_parts" in phases:
            phase_sr_parts()
        if "zoo_grads" in phases:
            phase_zoo_grads()
        if "heads_forms" in phases:
            phase_heads_forms()
        for k in kernels:
            if k["name"] in ROUTE_TOTALS:
                k["launches_by_route"] = ROUTE_TOTALS[k["name"]]
            if k["name"] in GEMM_ROUTES:
                k["launches_by_gemm_route"] = ROUTE_TOTALS[
                    GEMM_ROUTES[k["name"]]]
        if set(PHASES) <= set(phases) and set(KERNEL_GROUPS) <= set(groups):
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
