"""GC-ViT global-query window attention: the wrapper of kernel K6 and its
plain PyTorch version.

Replaces the TPU kernel ``fused_global_window_attention`` (``_global_kernel``)
of ``medicalsemseg_tpu/ops/pallas/window_attention.py``: per window, [LN ->]
KV projection of the window's tokens; the queries are the batch element's one
ws^3 grid ``q_global[b]``, scaled and then rounded; per head q k^T + bias ->
fp32 softmax -> . V -> proj [-> + the raw window]. Inference only, as on the
TPU (no backward kernel there either). The CUDA source shares K1's file,
``csrc/window_attention.cu``; its header says what bounds K6 on the card and
how it differs from K1.

:func:`global_window_attention` takes windows already partitioned in
batch-major window order, as :func:`..window_attention.window_attention`
does. A CPU tensor goes through :func:`global_window_attention_plain`; a CUDA
tensor launches the kernel or raises. K6 runs K1's launches, so
:func:`..window_attention.window_attention_supported` is its predicate too.
"""

from __future__ import annotations

from typing import Optional

import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels.window_attention import (
    MAX_HEAD_DIM, ROUTES, head_runs, pick_gemm_route, pick_route,
    wide_scratch)
from medicalsemseg_tpu_torch.utils import profiling


def global_window_attention_plain(
    wins: torch.Tensor, q_global: torch.Tensor, wkv: torch.Tensor,
    bkv: Optional[torch.Tensor], wproj: torch.Tensor, bproj: torch.Tensor,
    bias: torch.Tensor, *, ln: Optional[torch.Tensor] = None,
    ln_eps: float = 1e-5, residual: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, rounding to ``wins.dtype`` at
    the kernel's points and accumulating in fp32."""
    dt = wins.dtype
    t, n, c = wins.shape
    nh = bias.shape[0]
    hd = c // nh
    b = q_global.shape[0]
    xn = (kernels.layer_norm(wins.float(), ln, ln_eps).to(dt)
          if ln is not None else wins)
    kv = xn.float() @ wkv.to(dt).float().t()
    if bkv is not None:
        kv = kv + bkv.float()
    kv = kv.to(dt).float().reshape(t, n, 2, nh, hd).permute(2, 0, 3, 1, 4)
    # scaled in fp32, then rounded; one query grid per batch element
    q = (q_global.float() * hd ** -0.5).to(dt).float()
    q = q.reshape(b, n, nh, hd).permute(0, 2, 1, 3)
    q = q.repeat_interleave(t // b, dim=0)
    attn = q @ kv[0].transpose(-1, -2) + bias.float()[None]
    p = torch.softmax(attn, dim=-1).to(dt).float()
    out = (p @ kv[1]).permute(0, 2, 1, 3).reshape(t, n, c).to(dt)
    out = (out.float() @ wproj.to(dt).float().t() + bproj.float()).to(dt)
    if residual:
        out = out + wins
    return out


@profiling.spanned("K6")
def global_window_attention(
    wins: torch.Tensor, q_global: torch.Tensor, wkv: torch.Tensor,
    bkv: Optional[torch.Tensor], wproj: torch.Tensor, bproj: torch.Tensor,
    bias: torch.Tensor, *, ln: Optional[torch.Tensor] = None,
    ln_eps: float = 1e-5, residual: bool = False, route: Optional[str] = None,
    gemm_route: Optional[str] = None,
) -> torch.Tensor:
    """Windows (T, N, C) and global queries (B, N, C) -> attention output
    windows (T, N, C); window g belongs to batch element g // (T // B).

    ``wkv`` (2C, C: K rows, then V rows, head-major) and ``wproj`` (C, C) are
    [out, in] weights, cast to the activation dtype here as the JAX kernel
    casts them (``wins`` and ``q_global`` bf16, fp16 or fp32); ``bkv`` (2C,)
    or None, ``bproj`` (C,), ``ln`` (2, C) scale and bias rows and the gathered
    relative-position ``bias`` (nh, N, N) are fp32. With ``ln`` the windows
    are raw and the kernel applies the block's LayerNorm to them (never to
    the queries); with ``residual`` it adds the raw windows. ``route`` and
    ``gemm_route`` name the heads and projection launches' routes, as for
    K1."""
    kw = dict(ln=ln, ln_eps=ln_eps, residual=residual)
    if wins.device.type == "cpu":
        return global_window_attention_plain(wins, q_global, wkv, bkv, wproj,
                                             bproj, bias, **kw)
    if wins.device.type != "cuda":
        raise ValueError(f"global_window_attention: no kernel for {wins.device}")
    return _launch(wins, q_global, wkv, bkv, wproj, bproj, bias, route=route,
                   gemm_route=gemm_route, **kw)


def _launch(wins, q_global, wkv, bkv, wproj, bproj, bias, *, ln, ln_eps,
            residual, route, gemm_route=None):
    """K6 on ``wins``' device: the checks, the launch and its counts."""
    t, n, c = wins.shape
    nh = bias.shape[0]
    hd = c // nh
    b = q_global.shape[0]
    if b < 1 or t % b != 0:
        raise ValueError(f"{t} windows do not divide over {b} query grids")
    if hd * nh != c or hd > MAX_HEAD_DIM:
        raise ValueError(f"C={c} with {nh} heads: head dim must divide C and "
                         f"be <= {MAX_HEAD_DIM}")
    dev, dt, f32 = wins.device, wins.dtype, torch.float32
    code = kernels.dtype_code("wins", dt)
    route = pick_route(route, dt, n, hd)
    gemm = pick_gemm_route(gemm_route, dt, c)
    wkv, wproj = wkv.to(dt), wproj.to(dt)
    kernels.check_tensor("wins", wins, dev, dt)
    kernels.check_tensor("q_global", q_global, dev, dt, (b, n, c))
    kernels.check_tensor("wkv", wkv, dev, dt, (2 * c, c))
    kernels.check_tensor("wproj", wproj, dev, dt, (c, c))
    kernels.check_tensor("bproj", bproj, dev, f32, (c,))
    kernels.check_tensor("bias", bias, dev, f32, (nh, n, n))
    if bkv is not None:
        kernels.check_tensor("bkv", bkv, dev, f32, (2 * c,))
    if ln is not None:
        kernels.check_tensor("ln", ln, dev, f32, (2, c))

    if gemm == "tensor_core":
        kernels.check_aligned(wins=wins, wproj=wproj)

    lib = kernels.load()
    attn = torch.empty_like(wins)
    out = torch.empty_like(wins)
    runs = head_runs(t, nh, kernels.resident_blocks(dev))
    scratch = wide_scratch(runs, n, c, nh, dt, dev)
    err = lib.medseg_global_window_attention_fwd(
        kernels.ptr(wins), kernels.ptr(ln), kernels.ptr(q_global),
        kernels.ptr(wkv), kernels.ptr(bkv), kernels.ptr(wproj),
        kernels.ptr(bproj), kernels.ptr(bias), kernels.ptr(attn),
        kernels.ptr(out), kernels.ptr(scratch), t, n, c, nh, t // b, runs,
        int(residual), ROUTES[gemm],
        ROUTES[route], code, float(ln_eps), float(hd ** -0.5),
        kernels.stream_handle(dev))
    kernels.check(lib, err, "global_window_attention")
    # two launches a call, by K1's pickers' routes (attention_route,
    # gemm_route)
    kernels.count_launch("K6", "heads", route)
    kernels.count_launch("K6", "gemm", gemm)
    return out
