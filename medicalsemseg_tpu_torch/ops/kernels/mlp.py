"""Fused token MLP: the wrappers of kernels K2 (forward) and K4 (backward),
their plain PyTorch versions, and the autograd function that joins them.

Replaces the TPU kernels of ``medicalsemseg_tpu/ops/pallas/mlp.py``:
``fused_mlp`` (``_kernel``): [LN ->] fc1 -> exact GELU -> fc2 [-> +x], with
the (M, 4C) hidden activations kept on chip, and ``_fm_bwd``
(``_bwd_kernel``), which recomputes them per tile and returns dx and every
parameter gradient. The CUDA sources are ``csrc/mlp.cu`` and
``csrc/mlp_bwd.cu``; their headers say what bounds them on the card and how
the designs answer that.

Each kernel has two routes, picked by :func:`mlp_route` and
:func:`mlp_bwd_route` from the dtype and the shape alone: the tensor cores
(``mma.sync``; bf16 and fp16 with C, Co and H multiples of 16: every model
path of the flagship and the zoo at their shipped widths) and the CUDA cores
(fp32, whose agreement with the fp32 plain path TF32 would cost, and any
other shape). A failed launch raises; nothing falls back to the other route.

A CPU tensor goes through :func:`fused_mlp_plain` /
:func:`fused_mlp_bwd_plain`; a CUDA tensor launches the kernel or raises.

:func:`fused_mlp_supported` says from the dtype and the shape alone whether
K2 (and, in training, K4) takes a block's MLP: C and Co up to 768, and in
training Co == C.
"""

from __future__ import annotations

import functools

from typing import Optional

import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.ops import kernels

# kernel launches through fused_mlp() and fused_mlp_bwd(), and the same by
# route
launches = 0
bwd_launches = 0
ROUTES = kernels.ROUTES
route_launches = dict.fromkeys(ROUTES, 0)
bwd_route_launches = dict.fromkeys(ROUTES, 0)

# The widest C and Co of K2 and K4, on either route. K2 on the CUDA cores:
# shared memory per block grows with C and Co (csrc/mlp.cu), 203 KB of the
# 227 KB limit at C = Co = 512; above that Co comes in column tiles (two at
# C = Co = 768, 220 KB in fp32). K2 on the tensor cores: a 64-token tile and
# a W1 chunk of 64 hidden units, each C + 8 wide, sit beside a W2 chunk of
# <= 192 output columns: 222 KB at C = 768; Co comes in column tiles. K4 on
# the CUDA cores: the dx launch holds three (32, C) fp32 tiles, 211 KB at
# C = 384, and 16-row tiles above. K4 on the tensor cores: the dx launch
# splits C into at most four column parts of <= 96 channels (dx_parts), so
# C <= 384 there.
MAX_WIDTH = 768

# the tensor-core kernels (csrc/mlp_tile.cuh): token rows a tile, hidden
# units a chunk, widest column tile of K2, widest channel slice of K4's
# weight-gradient launch and column part of its dx launch
TC_TILE_ROWS = 64
TC_HIDDEN_CHUNK = 64
TC_MAX_CO_TILE = 192
TC_MAX_SLICE = 96

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


@functools.lru_cache(maxsize=None)
def fused_mlp_supported(dtype, c: int, co: int, hdim: int,
                        train: bool = False) -> bool:
    """Whether K2 and, with ``train``, K4 take tokens of width C, hidden
    width H and Co outputs in ``dtype``: bf16, fp16 or fp32 with C, Co <=
    768; for K4 also Co == C (K4's tensor-core route takes C <= 384, its
    CUDA-core route the rest). Pure: calls no library."""
    if dtype not in (torch.bfloat16, torch.float16, torch.float32):
        return False
    if min(c, co, hdim) < 1 or max(c, co) > MAX_WIDTH:
        return False
    return not train or co == c


def mlp_route(dtype, c: int, co: int, hdim: int) -> str:
    """The route of a K2 launch: ``"tensor_core"`` for bf16 and fp16 with C,
    Co and H multiples of 16 and C, Co <= 768, else ``"cuda_core"``."""
    if (kernels.tensor_core_dtype(dtype) and c % 16 == 0 and co % 16 == 0
            and hdim % 16 == 0 and max(c, co) <= MAX_WIDTH):
        return "tensor_core"
    return "cuda_core"


def dx_parts(c: int) -> int:
    """Column parts of <= 96 channels, a multiple of 16 each, in which K4's
    tensor-core dx launch splits C over its four warps: 1, 2 or 4; 0 where
    there are none (csrc/mlp_tile.cuh, mlp_dx_parts)."""
    for parts in (1, 2, 4):
        if c % (16 * parts) == 0 and c // parts <= TC_MAX_SLICE:
            return parts
    return 0


def mlp_bwd_route(dtype, c: int, hdim: int) -> str:
    """The route of a K4 launch: ``"tensor_core"`` for bf16 and fp16 with H
    a multiple of 16 and C in :func:`dx_parts` (every multiple of 16 up to
    96, of 32 up to 192, of 64 up to 384), else ``"cuda_core"``."""
    if kernels.tensor_core_dtype(dtype) and hdim % 16 == 0 and dx_parts(c):
        return "tensor_core"
    return "cuda_core"


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def co_tile(co: int) -> int:
    """Output columns a block of the tensor-core K2 computes: Co cut into
    the fewest equal tiles of a multiple of 16 and at most 192 (each tile
    computes fc1 again)."""
    for tiles in range(1, co // 16 + 1):
        if co % tiles == 0 and (co // tiles) % 16 == 0 \
                and co // tiles <= TC_MAX_CO_TILE:
            return co // tiles
    raise ValueError(f"Co={co} is no multiple of 16")


def fwd_plan(m: int, co: int, hdim: int, sms: int):
    """(co_tile, hsplit) of a tensor-core K2 launch: where the token tiles
    and column tiles give fewer than two blocks an SM (the deep stages), H
    is split over blocks, whose fp32 partials of y are added in order."""
    cot = co_tile(co)
    blocks = _ceil(m, TC_TILE_ROWS) * (co // cot)
    nch = _ceil(hdim, TC_HIDDEN_CHUNK)
    hsplit = max(1, min(nch, (2 * sms) // blocks))
    return cot, _ceil(nch, _ceil(nch, hsplit))


def slice_width(c: int) -> int:
    """Channels of the weight gradients a block of K4's tensor-core
    weight-gradient launch owns: the widest of 96, 64, 48, 32, 16 dividing C
    (each slice computes h and da again)."""
    for width in (96, 64, 48, 32, 16):
        if c % width == 0:
            return width
    raise ValueError(f"C={c} is no multiple of 16")


def bwd_plan(m: int, c: int, hdim: int, sms: int):
    """(slice, shares, dx blocks, padded M) of a tensor-core K4 launch: four
    blocks an SM in each launch, the dx launch over tiles of 64 / dx_parts(C)
    rows, the dhb scratch (H, padded M)."""
    tiles = _ceil(m, TC_TILE_ROWS)
    sl = slice_width(c)
    groups = _ceil(hdim, TC_HIDDEN_CHUNK) * (c // sl)
    shares = max(1, min(tiles, (4 * sms) // groups))
    grid_a = min(_ceil(m, TC_TILE_ROWS // dx_parts(c)), 4 * sms)
    return sl, shares, grid_a, tiles * TC_TILE_ROWS


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              ln: Optional[torch.Tensor] = None, ln_eps: float = 1e-5,
              residual: bool = False, route: Optional[str] = None
              ) -> torch.Tensor:
    """Tokens (M, C) -> (M, Co).

    ``x`` is bf16, fp16 or fp32; ``w1`` (H, C) and ``w2`` (Co, H) are [out,
    in] weights, cast to the activation dtype here as the JAX kernel casts
    them; ``b1``, ``b2`` and ``ln`` (2, C: scale row, bias row) are fp32.
    With ``ln`` the tokens are raw and the kernel applies the LayerNorm;
    with ``residual`` (Co == C) it adds the raw tokens. ``route`` names the
    kernel's route (default: :func:`mlp_route`)."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, ln, ln_eps, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no kernel for {x.device}")
    return _launch_fwd(x, w1, b1, w2, b2, ln, ln_eps, residual, route)


def _launch_fwd(x, w1, b1, w2, b2, ln, ln_eps, residual, route):
    """K2 on ``x``'s device: the checks, the plan, the launch and its
    counts."""
    m, c = x.shape
    hdim, co = w1.shape[0], w2.shape[0]
    if residual and co != c:
        raise ValueError(f"residual needs Co == C, got {co} != {c}")
    dev, dt, f32 = x.device, x.dtype, torch.float32
    code = kernels.dtype_code("x", dt)
    route = kernels.pick_route(route, mlp_route(dt, c, co, hdim),
                               f"{dt} with C={c}, Co={co}, H={hdim}")
    if max(c, co) > MAX_WIDTH:
        raise ValueError(f"width {max(c, co)} > {MAX_WIDTH}")
    w1, w2 = w1.to(dt), w2.to(dt)
    kernels.check_tensor("x", x, dev, dt)
    kernels.check_tensor("w1", w1, dev, dt, (hdim, c))
    kernels.check_tensor("b1", b1, dev, f32, (hdim,))
    kernels.check_tensor("w2", w2, dev, dt, (co, hdim))
    kernels.check_tensor("b2", b2, dev, f32, (co,))
    if ln is not None:
        kernels.check_tensor("ln", ln, dev, f32, (2, c))

    global launches
    lib = kernels.load()
    out = torch.empty((m, co), dtype=dt, device=dev)
    cot, hsplit, part = 0, 0, None
    if route == "tensor_core":
        kernels.check_aligned(x=x, w1=w1, w2=w2)
        cot, hsplit = fwd_plan(m, co, hdim, kernels.sm_count(dev))
        if hsplit > 1:
            part = torch.empty((hsplit, m, co), dtype=f32, device=dev)
    err = lib.medseg_fused_mlp_fwd(
        kernels.ptr(x), kernels.ptr(ln), kernels.ptr(w1), kernels.ptr(b1),
        kernels.ptr(w2), kernels.ptr(b2), kernels.ptr(out), kernels.ptr(part),
        m, c, hdim, co, int(residual), ROUTES[route], cot, hsplit, code,
        float(ln_eps), kernels.stream_handle(dev))
    kernels.check(lib, err, "fused_mlp")
    launches += 1
    route_launches[route] += 1
    return out


def gelu_cdf(h: torch.Tensor) -> torch.Tensor:
    """Phi(h) with erf from Abramowitz & Stegun 7.1.26 (abs err <= 1.5e-7),
    the polynomial the TPU kernels and the tensor-core K2 and both routes of
    K4 evaluate."""
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
                  ln_eps: float = 1e-5, residual: bool = False,
                  route: Optional[str] = None):
    """Gradients of :func:`fused_mlp` with the LayerNorm absorbed (Co == C)
    for the output gradient ``dy`` (M, C); arguments and results as in
    :func:`fused_mlp_bwd_plain`. ``route`` names the kernel's route
    (default: :func:`mlp_bwd_route`)."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(x, w1, b1, w2, ln, dy, ln_eps, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_bwd: no kernel for {x.device}")
    return _launch_bwd(x, w1, b1, w2, ln, dy, ln_eps, residual, route)


def _launch_bwd(x, w1, b1, w2, ln, dy, ln_eps, residual, route):
    """K4 on ``x``'s device: the checks, the plan, the launch and its
    counts."""
    m, c = x.shape
    hdim = w1.shape[0]
    if c > MAX_WIDTH:
        raise ValueError(f"width {c} > {MAX_WIDTH}")
    dev, dt, f32 = x.device, x.dtype, torch.float32
    code = kernels.dtype_code("x", dt)
    route = kernels.pick_route(route, mlp_bwd_route(dt, c, hdim),
                               f"{dt} with C={c}, H={hdim}")
    w1, w2 = w1.to(dt), w2.to(dt)
    kernels.check_tensor("x", x, dev, dt)
    kernels.check_tensor("dy", dy, dev, dt, (m, c))
    kernels.check_tensor("w1", w1, dev, dt, (hdim, c))
    kernels.check_tensor("b1", b1, dev, f32, (hdim,))
    kernels.check_tensor("w2", w2, dev, dt, (c, hdim))
    kernels.check_tensor("ln", ln, dev, f32, (2, c))

    global bwd_launches
    lib = kernels.load()
    dhb, sl = None, 0
    if route == "tensor_core":
        kernels.check_aligned(x=x, dy=dy, w1=w1, w2=w2)
        sl, nsplit, grid_a, mp = bwd_plan(m, c, hdim, kernels.sm_count(dev))
        dhb = torch.empty((hdim, mp), dtype=dt, device=dev)
    else:
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
        kernels.ptr(w2), kernels.ptr(dy), kernels.ptr(dx), kernels.ptr(dhb),
        kernels.ptr(part_a), kernels.ptr(out_a), kernels.ptr(part_w),
        kernels.ptr(out_w), m, c, hdim, grid_a, nsplit, sl, int(residual),
        ROUTES[route], code, float(ln_eps), kernels.stream_handle(dev))
    kernels.check(lib, err, "fused_mlp_bwd")
    bwd_launches += 1
    bwd_route_launches[route] += 1
    hc = hdim * c
    # the tensor-core kernels sum dW2 transposed (csrc/mlp_bwd.cu)
    dw2 = (out_w[hc:2 * hc].view(hdim, c).t() if route == "tensor_core"
           else out_w[hc:2 * hc].view(c, hdim))
    return (dx, out_a[:2 * c].view(2, c), out_w[:hc].view(hdim, c),
            out_w[2 * hc:], dw2, out_a[2 * c:])


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
