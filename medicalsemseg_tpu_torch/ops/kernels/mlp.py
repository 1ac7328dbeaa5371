"""Fused token MLP: the wrappers of kernels K2 (forward) and K4 (backward),
their plain PyTorch versions, and the autograd function that joins them.

Replaces the TPU kernels of ``medicalsemseg_tpu/ops/pallas/mlp.py``:
``fused_mlp`` (``_kernel``): [LN ->] fc1 -> exact GELU -> fc2 [-> +x], with
the (M, 4C) hidden activations kept on chip, and ``_fm_bwd``
(``_bwd_kernel``), which recomputes them per tile and returns dx and every
parameter gradient. The CUDA sources are ``csrc/mlp.cu`` and
``csrc/mlp_bwd.cu``; their headers say what bounds them on the card and how
the designs answer that.

A CPU tensor goes through :func:`fused_mlp_plain` /
:func:`fused_mlp_bwd_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.ops import kernels

# kernel launches through fused_mlp() and fused_mlp_bwd()
launches = 0
bwd_launches = 0

# shared memory per block grows with C and Co (csrc/mlp.cu): 203 KB of the
# 227 KB limit at C = Co = 512
MAX_WIDTH = 512
# the backward's dx launch holds three (32, C) fp32 tiles: 211 KB at C = 384
MLP_BWD_MAX_WIDTH = 384

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def fused_mlp_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor,
                    ln: Optional[torch.Tensor] = None, ln_eps: float = 1e-5,
                    residual: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch, rounding to ``x.dtype`` at the
    kernel's points and accumulating in fp32."""
    dt = x.dtype
    xn = kernels.layer_norm(x.float(), ln, ln_eps).to(dt) if ln is not None else x
    h = xn.float() @ w1.to(dt).float().t() + b1.float()
    h = F.gelu(h).to(dt)
    y = (h.float() @ w2.to(dt).float().t() + b2.float()).to(dt)
    if residual:
        y = y + x
    return y


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              ln: Optional[torch.Tensor] = None, ln_eps: float = 1e-5,
              residual: bool = False) -> torch.Tensor:
    """Tokens (M, C) -> (M, Co).

    ``w1`` (H, C) and ``w2`` (Co, H) are [out, in] weights in the activation
    dtype; ``b1``, ``b2`` and ``ln`` (2, C: scale row, bias row) are fp32.
    With ``ln`` the tokens are raw and the kernel applies the LayerNorm;
    with ``residual`` (Co == C) it adds the raw tokens."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, ln, ln_eps, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no kernel for {x.device}")

    m, c = x.shape
    hdim, co = w1.shape[0], w2.shape[0]
    if residual and co != c:
        raise ValueError(f"residual needs Co == C, got {co} != {c}")
    if max(c, co) > MAX_WIDTH:
        raise ValueError(f"width {max(c, co)} > {MAX_WIDTH}")
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    kernels.check_tensor("x", x, dev, bf)
    kernels.check_tensor("w1", w1, dev, bf, (hdim, c))
    kernels.check_tensor("b1", b1, dev, f32, (hdim,))
    kernels.check_tensor("w2", w2, dev, bf, (co, hdim))
    kernels.check_tensor("b2", b2, dev, f32, (co,))
    if ln is not None:
        kernels.check_tensor("ln", ln, dev, f32, (2, c))

    global launches
    lib = kernels.load()
    out = torch.empty((m, co), dtype=bf, device=dev)
    err = lib.medseg_fused_mlp_fwd(
        kernels.ptr(x), kernels.ptr(ln), kernels.ptr(w1), kernels.ptr(b1),
        kernels.ptr(w2), kernels.ptr(b2), kernels.ptr(out), m, c, hdim, co,
        int(residual), float(ln_eps), kernels.stream_handle(dev))
    kernels.check(lib, err, "fused_mlp")
    launches += 1
    return out


def gelu_cdf(h: torch.Tensor) -> torch.Tensor:
    """Phi(h) with erf from Abramowitz & Stegun 7.1.26 (abs err <= 1.5e-7),
    the polynomial the TPU kernels and ``csrc/mlp_bwd.cu`` evaluate."""
    x = h * _INV_SQRT2
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return 0.5 * (1.0 + torch.sign(x) * (1.0 - poly * torch.exp(-a * a)))


def fused_mlp_bwd_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, ln: torch.Tensor, dy: torch.Tensor,
                        ln_eps: float = 1e-5, residual: bool = False):
    """The backward kernel's function in plain PyTorch, written out with
    the kernel's rounding points (not autograd of the forward). Returns
    (dx, dln (2, C), dw1 (H, C), db1, dw2 (C, H), db2); dx in ``x.dtype``,
    the rest fp32."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    inv = torch.rsqrt(var + ln_eps)
    xhat = (xf - mu) * inv
    xn = (xhat * ln[0] + ln[1]).to(dt).float()
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    h = xn @ w1f.t() + b1.float()
    cdf = gelu_cdf(h)
    hb = (h * cdf).to(dt).float()
    dyf = dy.to(dt).float()

    dw2 = dyf.t() @ hb
    db2 = dyf.sum(0)
    da = dyf @ w2f
    dh = da * (cdf + h * (torch.exp(-0.5 * h * h) * _INV_SQRT_2PI))
    dhb = dh.to(dt).float()
    dw1 = dhb.t() @ xn
    db1 = dh.sum(0)
    dxn = dhb @ w1f

    dxhat = dxn * ln[0]
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (dxhat - m1 - xhat * m2) * inv
    dln = torch.stack([(dxn * xhat).sum(0), dxn.sum(0)])
    if residual:
        dx = dx + dyf
    return dx.to(dt), dln, dw1, db1, dw2, db2


def fused_mlp_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, ln: torch.Tensor, dy: torch.Tensor,
                  ln_eps: float = 1e-5, residual: bool = False):
    """Gradients of :func:`fused_mlp` with the LayerNorm absorbed (Co == C)
    for the output gradient ``dy`` (M, C); arguments and results as in
    :func:`fused_mlp_bwd_plain`."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(x, w1, b1, w2, ln, dy, ln_eps, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_bwd: no kernel for {x.device}")

    m, c = x.shape
    hdim = w1.shape[0]
    if c > MLP_BWD_MAX_WIDTH:
        raise ValueError(f"width {c} > {MLP_BWD_MAX_WIDTH}")
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    kernels.check_tensor("x", x, dev, bf)
    kernels.check_tensor("dy", dy, dev, bf, (m, c))
    kernels.check_tensor("w1", w1, dev, bf, (hdim, c))
    kernels.check_tensor("b1", b1, dev, f32, (hdim,))
    kernels.check_tensor("w2", w2, dev, bf, (c, hdim))
    kernels.check_tensor("ln", ln, dev, f32, (2, c))

    global bwd_launches
    lib = kernels.load()
    tiles = -(-m // kernels.TILE_ROWS)
    blocks = kernels.resident_blocks(dev)
    grid_a = min(tiles, blocks)
    nsplit = max(1, min(tiles, blocks // -(-hdim // 16)))
    nw = 2 * hdim * c + hdim
    dx = torch.empty_like(x)
    part_a = torch.empty((grid_a, 3 * c), dtype=f32, device=dev)
    out_a = torch.empty(3 * c, dtype=f32, device=dev)
    part_w = torch.empty((nsplit, nw), dtype=f32, device=dev)
    out_w = torch.empty(nw, dtype=f32, device=dev)
    err = lib.medseg_fused_mlp_bwd(
        kernels.ptr(x), kernels.ptr(ln), kernels.ptr(w1), kernels.ptr(b1),
        kernels.ptr(w2), kernels.ptr(dy), kernels.ptr(dx),
        kernels.ptr(part_a), kernels.ptr(out_a), kernels.ptr(part_w),
        kernels.ptr(out_w), m, c, hdim, grid_a, nsplit, int(residual),
        float(ln_eps), kernels.stream_handle(dev))
    kernels.check(lib, err, "fused_mlp_bwd")
    bwd_launches += 1
    hc = hdim * c
    return (dx, out_a[:2 * c].view(2, c), out_w[:hc].view(hdim, c),
            out_w[2 * hc:], out_w[hc:2 * hc].view(c, hdim), out_a[2 * c:])


class FusedMlpFn(torch.autograd.Function):
    """[x +] fc2(gelu(fc1(LN(x)))) on raw tokens x (M, C) in the compute
    dtype: forward = K2, backward = K4. Takes the fp32 parameters, casts the
    weights to the compute dtype inside and returns fp32 gradients, so no
    weight gradient is rounded through a bf16 cast."""

    @staticmethod
    def forward(ctx, x, ln, w1, b1, w2, b2, ln_eps, residual):
        dt = x.dtype
        ctx.save_for_backward(x, ln, w1, b1, w2)
        ctx.ln_eps, ctx.residual = ln_eps, residual
        return fused_mlp(x, w1.to(dt), b1.float(), w2.to(dt), b2.float(),
                         ln=ln.float(), ln_eps=ln_eps, residual=residual)

    @staticmethod
    def backward(ctx, dy):
        x, ln, w1, b1, w2 = ctx.saved_tensors
        dt = x.dtype
        dx, dln, dw1, db1, dw2, db2 = fused_mlp_bwd(
            x, w1.to(dt), b1.float(), w2.to(dt), ln.float(),
            dy.to(dt).contiguous(), ctx.ln_eps, ctx.residual)
        return (dx, dln.to(ln.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b1.dtype), None, None)
