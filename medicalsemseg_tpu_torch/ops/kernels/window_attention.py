"""Fused 3D window attention: the wrappers of kernels K1 (forward) and K3
(backward), their plain PyTorch versions, and the autograd function that
joins them.

Replaces the TPU kernels of
``medicalsemseg_tpu/ops/pallas/window_attention.py``:
``fused_window_attention`` (``_kernel`` + ``_window_mask``), and the two
backward functions ``_fused_bwd_windows`` (``_bwd_kernel``) and
``_fused_bwd_windows_hsplit`` (``_bwd_kernel_hsplit``), which one Hopper
kernel covers. The CUDA sources are ``csrc/window_attention.cu`` and
``csrc/window_attention_bwd.cu``; their headers say what bounds them on the
card and how the designs answer that.

The heads launches of K1, K3 and K6 have two routes, picked by
:func:`attention_route` from the dtype and the shape alone: the tensor cores
(``mma.sync``; bf16 and fp16 at head dim 16 with at most 224 tokens a
window: every model path of the flagship, GCViTUNETR and SwinSegFormer at
their shipped widths) and the CUDA cores (fp32, whose agreement with the
fp32 plain path TF32 would cost, and any other head dim). The GEMM launches
(K1's and K6's projection, K3's dx and dw) have two routes of their own,
picked by :func:`gemm_route` from the dtype and the width alone: the tensor
cores for bf16 and fp16 with C in column parts of at most 96 (every shipped
width) and the CUDA cores otherwise. A failed launch raises; nothing falls
back to the other route.

:func:`window_attention` takes windows that were already partitioned (and,
for a shifted block, cyclically rolled by -shift) in batch-major window
order, and returns the attention output windows;
:func:`window_attention_bwd` returns the gradients for an output gradient. A
CPU tensor goes through :func:`window_attention_plain` /
:func:`window_attention_bwd_plain`; a CUDA tensor launches the kernel or
raises.

:func:`window_attention_supported` says from the dtype and the shape alone
whether K1 (and, in training, K3) takes a block's windows: head dims up to
96, C up to 768, windows of up to 7^3 tokens (6^3 in training), and in
training C a multiple of 8. Head dims above 16 (K1, K6) and 32 (K3) take
the CUDA-core heads launches' wide form (``csrc/attn_wide.cuh``): a block
owns a head and a run of windows and keeps its q, k, v (and K3's dout) in a
scratch buffer that the wrapper allocates (:func:`wide_scratch`); the
wrapper picks the form by handing it or not.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
from medicalsemseg_tpu_torch.ops.window import (_official_attn_mask,
                                                gather_rel_bias)
from medicalsemseg_tpu_torch.utils import profiling

Tuple3 = Tuple[int, int, int]

MAX_HEAD_DIM = 96
# the largest head dims of the one-pass CUDA-core heads forms of K1 / K6 and
# of K3; above them the wide form (csrc/attn_wide.cuh) runs. Measured on an
# H100 (chip_smoke.py --phases heads_forms, PERF.md PR 12), the wide form
# of K1 and K6 took 0.74-0.96 of the one-pass form's time at head dim 32 at
# the flagship's first three stages of hidden 96 and 1.25-1.35 at the
# fourth (48 blocks either way), 0.95-1.57 at head dim 16; K3's took
# 1.09-2.43 at both.
NARROW_HEAD_DIM = 16
BWD_NARROW_HEAD_DIM = 32
ATTN_BWD_MAX_WIDTH = 768
# the widest window whose CUDA-core heads block fits the card's shared
# memory (fp32 tiles growing with N): 7^3 tokens for K1, 6^3 for K3
MAX_TOKENS, BWD_MAX_TOKENS = 343, 216

# the routes of the heads launches, with their codes in the C entry points
ROUTES = kernels.ROUTES
TC_HEAD_DIM = 16
TC_MAX_TOKENS = 224
# K1's calls by the route of their heads launch, a read-only view of the
# launch registry (``kernels.launches``) under the name the benchmark reads;
# ``bwd_launches``, K3's calls, is the module's ``__getattr__``
route_launches = kernels.RouteCounts("K1", "heads")
# dW rows a block of K3's tensor-core dw launch owns: four warps of three
# 16-row m-tiles at C <= 48 (all of [dWqkv | dWproj]), of two above
DW_ROWS_NARROW, DW_ROWS = 192, 128


def __getattr__(name: str):
    if name == "bwd_launches":
        return kernels.launches("K3", "heads")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def attention_route(dtype, n: int, head_dim: int) -> str:
    """The route of a heads launch: ``"tensor_core"`` for bf16 and fp16 at
    head dim 16 with at most 224 tokens a window, else ``"cuda_core"``."""
    if (dtype in (torch.bfloat16, torch.float16) and head_dim == TC_HEAD_DIM
            and n <= TC_MAX_TOKENS):
        return "tensor_core"
    return "cuda_core"


@functools.lru_cache(maxsize=None)
def window_attention_supported(dtype, n: int, c: int, num_heads: int,
                               train: bool = False) -> bool:
    """Whether K1 (K6 shares its launches) and, with ``train``, K3 take
    windows of N tokens of width C over ``num_heads`` heads in ``dtype``:
    bf16, fp16 or fp32, a head dim that divides C and is at most 96, C <=
    768 and N <= 343; for K3 also C a multiple of 8 and N <= 216 (the
    tensor-core routes take a subset). Pure: calls no library."""
    if dtype not in (torch.bfloat16, torch.float16, torch.float32):
        return False
    hd = c // num_heads if num_heads > 0 else 0
    if not (1 <= hd <= MAX_HEAD_DIM and hd * num_heads == c
            and c <= ATTN_BWD_MAX_WIDTH and 1 <= n <= MAX_TOKENS):
        return False
    return not train or (c % 8 == 0 and n <= BWD_MAX_TOKENS)


def pick_route(route: Optional[str], dtype, n: int, head_dim: int) -> str:
    """``route`` if given (it must be one the kernel takes for this dtype and
    shape), else :func:`attention_route`."""
    return kernels.pick_route(route, attention_route(dtype, n, head_dim),
                              f"{dtype} with head dim {head_dim} and {n} "
                              "tokens a window")


def gemm_width(c: int) -> int:
    """Columns of the tensor-core GEMM launches' tiles: C up to 96, else the
    widest multiple of 16 up to 96 dividing C (csrc/mlp_tile.cuh,
    gemm_width): the projection's column tile and k chunk, and the channel
    slice of K3's dw launch."""
    if c <= 96:
        return c
    return next(w for w in range(96, 0, -16) if c % w == 0)


def gemm_route(dtype, c: int) -> str:
    """The route of the GEMM launches (K1's and K6's projection, K3's dx and
    dw): ``"tensor_core"`` for bf16 and fp16 with C in the column parts of
    K4's dx launch (:func:`..mlp.dx_parts`: every multiple of 16 up to 96, of
    32 up to 192, of 64 up to 384), else ``"cuda_core"``."""
    if kernels.tensor_core_dtype(dtype) and kmlp.dx_parts(c):
        return "tensor_core"
    return "cuda_core"


def pick_gemm_route(route: Optional[str], dtype, c: int) -> str:
    """``route`` if given (it must be one the GEMM launches take for this
    dtype and width), else :func:`gemm_route`."""
    return kernels.pick_route(route, gemm_route(dtype, c),
                              f"{dtype} with C={c} (GEMM launches)")


def bwd_gemm_plan(m: int, c: int, blocks: int):
    """(dx blocks, token shares) of K3's tensor-core dx and dw launches, the
    most each may take of ``blocks`` (kernels.resident_blocks: four an SM;
    the C entry point cuts both to the blocks resident on the card at once):
    the dx launch over tiles of 64 / dx_parts(C) rows, the dw launch with
    (row groups x channel slices) blocks a share over 64-token tiles."""
    grid_dx = min(-(-m // (kmlp.TC_TILE_ROWS // kmlp.dx_parts(c))), blocks)
    rows = DW_ROWS_NARROW if c <= 48 else DW_ROWS
    groups = -(-4 * c // rows) * (c // gemm_width(c))
    tiles = -(-m // kmlp.TC_TILE_ROWS)
    return grid_dx, max(1, min(tiles, blocks // groups))


def head_runs(t: int, nh: int, blocks: int) -> int:
    """Runs of windows of a heads launch whose blocks each own a head and a
    run (K3's, and K1's and K6's wide form): the T windows
    spread over ``blocks // nh`` runs of ceil(T / runs) windows, every run
    holding a window (the C entry points take the count and cut the runs
    alike)."""
    per_run = -(-t // max(1, blocks // nh))
    return -(-t // per_run)


def wide_scratch(runs: int, n: int, c: int, nh: int, dtype, device,
                 bwd: bool = False) -> Optional[torch.Tensor]:
    """The scratch buffer of a heads launch's wide form: (N, hd) tiles of
    q, k, v (K3, ``bwd``: and dout) for each (run, head) block, in the
    activations' dtype, whose values they hold exactly; None, which picks
    the one-pass form, at head dims up to NARROW_HEAD_DIM (K3:
    BWD_NARROW_HEAD_DIM)."""
    hd = c // nh
    if hd <= (BWD_NARROW_HEAD_DIM if bwd else NARROW_HEAD_DIM):
        return None
    return torch.empty((runs * nh, 4 if bwd else 3, n, hd), dtype=dtype,
                       device=device)


def _qkv_heads(xn, wqkv, bqkv, nh):
    """q, k, v (T, nh, N, hd) as fp32 values rounded to ``xn.dtype``."""
    dt = xn.dtype
    t, n, c = xn.shape
    qkv = xn.float() @ wqkv.to(dt).float().t()
    if bqkv is not None:
        qkv = qkv + bqkv.float()
    qkv = qkv.to(dt).float().reshape(t, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def _scores(q, k, bias, grid_dims, window, shift):
    """fp32 logits (T, nh, N, N): q k^T * hd^-0.5 + bias + shifted mask. The
    mask comes from the region grid of MONAI's ``compute_mask``
    (``_official_attn_mask``: any per-axis window and shift, 0 on some axes
    included), independently of the kernels' per-token label formula."""
    t, nh, n, hd = q.shape
    attn = (q @ k.transpose(-1, -2)) * (hd ** -0.5) + bias.float()[None]
    if any(s > 0 for s in shift):
        dims = tuple(g * w for g, w in zip(grid_dims, window))
        mask = torch.from_numpy(_official_attn_mask(dims, tuple(window),
                                                    tuple(shift)))
        nw = mask.shape[0]
        attn = (attn.reshape(t // nw, nw, nh, n, n)
                + mask.to(attn.device)[None, :, None]).reshape(t, nh, n, n)
    return attn


def window_attention_plain(
    wins: torch.Tensor, wqkv: torch.Tensor, bqkv: Optional[torch.Tensor],
    wproj: torch.Tensor, bproj: torch.Tensor, bias: torch.Tensor, *,
    grid_dims: Tuple3, window: Tuple3, shift: Tuple3,
    ln: Optional[torch.Tensor] = None, ln_eps: float = 1e-5,
    residual: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, rounding to ``wins.dtype`` at
    the kernel's points and accumulating in fp32."""
    dt = wins.dtype
    t, n, c = wins.shape
    nh = bias.shape[0]
    hd = c // nh
    xf = wins.float()
    xn = kernels.layer_norm(xf, ln, ln_eps).to(dt) if ln is not None else wins
    q, k, v = _qkv_heads(xn, wqkv, bqkv, nh)
    attn = _scores(q, k, bias, grid_dims, window, shift)
    p = torch.softmax(attn, dim=-1).to(dt).float()
    out = (p @ v).permute(0, 2, 1, 3).reshape(t, n, c).to(dt)
    out = (out.float() @ wproj.to(dt).float().t() + bproj.float()).to(dt)
    if residual:
        out = out + wins
    return out


@profiling.spanned("K1")
def window_attention(
    wins: torch.Tensor, wqkv: torch.Tensor, bqkv: Optional[torch.Tensor],
    wproj: torch.Tensor, bproj: torch.Tensor, bias: torch.Tensor, *,
    grid_dims: Tuple3, window: Tuple3, shift: Tuple3,
    ln: Optional[torch.Tensor] = None, ln_eps: float = 1e-5,
    residual: bool = False, route: Optional[str] = None,
    gemm_route: Optional[str] = None,
) -> torch.Tensor:
    """Windows (T, N, C) -> attention output windows (T, N, C).

    ``wins`` is bf16, fp16 or fp32, and the kernel rounds to that dtype where
    the JAX kernel does. ``wqkv`` (3C, C) and ``wproj`` (C, C) are [out, in]
    weights, cast to the activation dtype here as the JAX kernel casts
    them; ``bqkv`` (3C,), ``bproj`` (C,), ``ln`` (2, C) scale and bias rows,
    and the gathered relative-position ``bias`` (nh, N, N) are fp32.
    ``grid_dims`` is the window grid (nwd, nwh, nww) of one volume, so
    T = B * nwd * nwh * nww. With ``ln`` the windows are raw and the kernel
    applies the block's LayerNorm; with ``residual`` it adds the raw windows.
    ``route`` names the heads launch's route (default: :func:`attention_route`),
    ``gemm_route`` the projection launch's (default: :func:`gemm_route`).
    """
    kw = dict(grid_dims=tuple(grid_dims), window=tuple(window),
              shift=tuple(shift), ln=ln, ln_eps=ln_eps, residual=residual)
    if wins.device.type == "cpu":
        return window_attention_plain(wins, wqkv, bqkv, wproj, bproj, bias, **kw)
    if wins.device.type != "cuda":
        raise ValueError(f"window_attention: no kernel for {wins.device}")
    return _launch_fwd(wins, wqkv, bqkv, wproj, bproj, bias, route=route,
                       gemm_route=gemm_route, **kw)


def _check_geometry(wins, nh, grid_dims, window):
    t, n, c = wins.shape
    hd = c // nh
    nwin = grid_dims[0] * grid_dims[1] * grid_dims[2]
    if n != window[0] * window[1] * window[2] or t % nwin != 0:
        raise ValueError(f"windows {tuple(wins.shape)} do not match window "
                         f"{window} / grid {grid_dims}")
    if hd * nh != c or hd > MAX_HEAD_DIM:
        raise ValueError(f"C={c} with {nh} heads: head dim must divide C and "
                         f"be <= {MAX_HEAD_DIM}")
    return t, n, c, hd


def _launch_fwd(wins, wqkv, bqkv, wproj, bproj, bias, *, grid_dims, window,
                shift, ln, ln_eps, residual, route, gemm_route=None):
    """K1 on ``wins``' device: the checks, the launch and its counts."""
    nh = bias.shape[0]
    t, n, c, hd = _check_geometry(wins, nh, grid_dims, window)
    dev, dt, f32 = wins.device, wins.dtype, torch.float32
    code = kernels.dtype_code("wins", dt)
    route = pick_route(route, dt, n, hd)
    gemm = pick_gemm_route(gemm_route, dt, c)
    wqkv, wproj = wqkv.to(dt), wproj.to(dt)
    kernels.check_tensor("wins", wins, dev, dt)
    kernels.check_tensor("wqkv", wqkv, dev, dt, (3 * c, c))
    kernels.check_tensor("wproj", wproj, dev, dt, (c, c))
    kernels.check_tensor("bproj", bproj, dev, f32, (c,))
    kernels.check_tensor("bias", bias, dev, f32, (nh, n, n))
    if bqkv is not None:
        kernels.check_tensor("bqkv", bqkv, dev, f32, (3 * c,))
    if ln is not None:
        kernels.check_tensor("ln", ln, dev, f32, (2, c))

    if gemm == "tensor_core":
        kernels.check_aligned(wins=wins, wproj=wproj)

    lib = kernels.load()
    attn = torch.empty_like(wins)
    out = torch.empty_like(wins)
    runs = head_runs(t, nh, kernels.resident_blocks(dev))
    scratch = wide_scratch(runs, n, c, nh, dt, dev)
    shifted = int(any(s > 0 for s in shift))
    err = lib.medseg_window_attention_fwd(
        kernels.ptr(wins), kernels.ptr(ln), kernels.ptr(wqkv),
        kernels.ptr(bqkv), kernels.ptr(wproj), kernels.ptr(bproj),
        kernels.ptr(bias), kernels.ptr(attn), kernels.ptr(out),
        kernels.ptr(scratch), t, n, c, nh, runs, *window, *shift,
        *grid_dims, shifted, int(residual), ROUTES[gemm], ROUTES[route], code,
        float(ln_eps), float(hd ** -0.5), kernels.stream_handle(dev))
    kernels.check(lib, err, "window_attention")
    kernels.count_launch("K1", "heads", route)
    kernels.count_launch("K1", "gemm", gemm)
    return out


def window_attention_bwd_plain(
    wins: torch.Tensor, wqkv: torch.Tensor, bqkv: Optional[torch.Tensor],
    wproj: torch.Tensor, bias: torch.Tensor, dy: torch.Tensor, *,
    grid_dims: Tuple3, window: Tuple3, shift: Tuple3,
    ln: Optional[torch.Tensor] = None, ln_eps: float = 1e-5,
    residual: bool = False,
):
    """The backward kernel's function in plain PyTorch, written out with
    the kernel's rounding points (not autograd of the forward). Returns
    (dx, dwqkv (3C, C), dbqkv, dwproj (C, C), dbproj, dbias (nh, N, N),
    dln (2, C) or None); dx in ``wins.dtype``, the rest fp32."""
    dt = wins.dtype
    t, n, c = wins.shape
    nh = bias.shape[0]
    hd = c // nh
    scale = hd ** -0.5
    xf = wins.float()
    if ln is not None:
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        inv = torch.rsqrt(var + ln_eps)
        xhat = (xf - mu) * inv
        xn = (xhat * ln[0] + ln[1]).to(dt)
    else:
        xn = wins
    q, k, v = _qkv_heads(xn, wqkv, bqkv, nh)
    p32 = torch.softmax(_scores(q, k, bias, grid_dims, window, shift), dim=-1)
    p = p32.to(dt).float()
    dyf = dy.to(dt).float()
    wqkvf, wprojf = wqkv.to(dt).float(), wproj.to(dt).float()

    heads = lambda a: a.reshape(t, n, nh, hd).permute(0, 2, 1, 3)  # noqa: E731
    merge = lambda a: a.permute(0, 2, 1, 3).reshape(t, n, c)       # noqa: E731
    o = merge((p @ v).to(dt).float())
    dout = heads((dyf @ wprojf).to(dt).float())
    dp = dout @ v.transpose(-1, -2)
    dv = p.transpose(-1, -2) @ dout
    ds = p32 * (dp - (dp * p32).sum(-1, keepdim=True))
    dbias = ds.sum(0)
    ds_l = (ds * scale).to(dt).float()
    dq = ds_l @ k
    dk = ds_l.transpose(-1, -2) @ q
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], -1).to(dt).float()

    rows = lambda a: a.reshape(t * n, -1)  # noqa: E731
    dwproj = rows(dyf).t() @ rows(o)
    dbproj = rows(dyf).sum(0)
    dwqkv = rows(dqkv).t() @ rows(xn.float())
    dbqkv = rows(dqkv).sum(0)
    dx = dqkv @ wqkvf
    dln = None
    if ln is not None:
        dxn = dx
        dxhat = dxn * ln[0]
        m1 = dxhat.mean(-1, keepdim=True)
        m2 = (dxhat * xhat).mean(-1, keepdim=True)
        dx = (dxhat - m1 - xhat * m2) * inv
        dln = torch.stack([rows(dxn * xhat).sum(0), rows(dxn).sum(0)])
    if residual:
        dx = dx + dyf
    return dx.to(dt), dwqkv, dbqkv, dwproj, dbproj, dbias, dln


def window_attention_bwd(
    wins: torch.Tensor, wqkv: torch.Tensor, bqkv: Optional[torch.Tensor],
    wproj: torch.Tensor, bias: torch.Tensor, dy: torch.Tensor, *,
    grid_dims: Tuple3, window: Tuple3, shift: Tuple3,
    ln: Optional[torch.Tensor] = None, ln_eps: float = 1e-5,
    residual: bool = False, route: Optional[str] = None,
    gemm_route: Optional[str] = None,
):
    """Gradients of :func:`window_attention` for the output gradient ``dy``
    (T, N, C); arguments and results as in
    :func:`window_attention_bwd_plain`, ``route`` (the heads launch's) and
    ``gemm_route`` (the dx and dw launches') as in :func:`window_attention`."""
    kw = dict(grid_dims=tuple(grid_dims), window=tuple(window),
              shift=tuple(shift), ln=ln, ln_eps=ln_eps, residual=residual)
    if wins.device.type == "cpu":
        return window_attention_bwd_plain(wins, wqkv, bqkv, wproj, bias, dy,
                                          **kw)
    if wins.device.type != "cuda":
        raise ValueError(f"window_attention_bwd: no kernel for {wins.device}")
    return _launch_bwd(wins, wqkv, bqkv, wproj, bias, dy, route=route,
                       gemm_route=gemm_route, **kw)


def _launch_bwd(wins, wqkv, bqkv, wproj, bias, dy, *, grid_dims, window,
                shift, ln, ln_eps, residual, route, gemm_route=None):
    """K3 on ``wins``' device: the checks, the plan, the launch and its
    counts."""
    nh = bias.shape[0]
    t, n, c, hd = _check_geometry(wins, nh, grid_dims, window)
    if c % 8 != 0 or c > ATTN_BWD_MAX_WIDTH:
        raise ValueError(f"C={c}: the backward kernel takes multiples of 8 "
                         f"up to {ATTN_BWD_MAX_WIDTH}")
    dev, dt, f32 = wins.device, wins.dtype, torch.float32
    code = kernels.dtype_code("wins", dt)
    route = pick_route(route, dt, n, hd)
    gemm = pick_gemm_route(gemm_route, dt, c)
    wqkv, wproj = wqkv.to(dt), wproj.to(dt)
    kernels.check_tensor("wins", wins, dev, dt)
    kernels.check_tensor("dy", dy, dev, dt, (t, n, c))
    kernels.check_tensor("wqkv", wqkv, dev, dt, (3 * c, c))
    kernels.check_tensor("wproj", wproj, dev, dt, (c, c))
    kernels.check_tensor("bias", bias, dev, f32, (nh, n, n))
    if bqkv is not None:
        kernels.check_tensor("bqkv", bqkv, dev, f32, (3 * c,))
    if ln is not None:
        kernels.check_tensor("ln", ln, dev, f32, (2, c))

    lib = kernels.load()
    blocks = kernels.resident_blocks(dev)
    # one block per (run of windows, head)
    nchunk = head_runs(t, nh, blocks)
    scratch = wide_scratch(nchunk, n, c, nh, dt, dev, bwd=True)
    stats = None
    if gemm == "tensor_core":
        kernels.check_aligned(wins=wins, wqkv=wqkv, dy=dy)
        grid_dx, nsplit = bwd_gemm_plan(t * n, c, blocks)
        if ln is not None:  # the dx launch's LayerNorm statistics, for dw's
            stats = torch.empty((t * n, 2), dtype=f32, device=dev)
    else:
        tiles = -(-(t * n) // kernels.TILE_ROWS)
        grid_dx = min(tiles, blocks)
        nsplit = max(1, min(tiles, blocks // (4 * c // 16)))
    nw = 4 * c * c + 4 * c
    # the CUDA-core route's key-row pass reads the bias transposed
    bias_t = (bias.transpose(1, 2).contiguous() if route == "cuda_core"
              else None)
    attn = torch.empty_like(wins)
    dqkv = torch.empty((t, n, 3 * c), dtype=dt, device=dev)
    dx = torch.empty_like(wins)
    # the tensor-core route adds every window's ds into its slab in L2
    dbias_part = (torch.zeros if route == "tensor_core" else torch.empty)(
        (nchunk, nh, n, n), dtype=f32, device=dev)
    dbias = torch.empty((nh, n, n), dtype=f32, device=dev)
    part_ln = torch.empty((grid_dx, 2 * c), dtype=f32, device=dev)
    out_ln = torch.empty((2, c), dtype=f32, device=dev)
    part_w = torch.empty((nsplit, nw), dtype=f32, device=dev)
    out_w = torch.empty(nw, dtype=f32, device=dev)
    shifted = int(any(s > 0 for s in shift))
    err = lib.medseg_window_attention_bwd(
        kernels.ptr(wins), kernels.ptr(ln), kernels.ptr(wqkv),
        kernels.ptr(bqkv), kernels.ptr(wproj), kernels.ptr(bias),
        kernels.ptr(bias_t), kernels.ptr(dy), kernels.ptr(attn),
        kernels.ptr(dqkv), kernels.ptr(dx), kernels.ptr(dbias_part),
        kernels.ptr(dbias), kernels.ptr(part_ln), kernels.ptr(out_ln),
        kernels.ptr(part_w), kernels.ptr(out_w), kernels.ptr(stats),
        kernels.ptr(scratch), t, n, c, nh, *window, *shift, *grid_dims, shifted, int(residual),
        nchunk, grid_dx, nsplit, ROUTES[gemm], ROUTES[route], code,
        float(ln_eps), float(hd ** -0.5), kernels.stream_handle(dev))
    kernels.check(lib, err, "window_attention_bwd")
    kernels.count_launch("K3", "heads", route)
    kernels.count_launch("K3", "gemm", gemm)
    cc = c * c
    return (dx, out_w[:3 * cc].view(3 * c, c), out_w[4 * cc:4 * cc + 3 * c],
            out_w[3 * cc:4 * cc].view(c, c), out_w[4 * cc + 3 * c:], dbias,
            out_ln if ln is not None else None)


class WindowAttentionFn(torch.autograd.Function):
    """Window attention on partitioned windows (T, N, C) in the compute
    dtype: forward = K1, backward = K3. Takes the fp32 parameters and the
    relative-position bias table (L, nh) with its (N*N,) gather index, casts
    the weights to the compute dtype inside and returns fp32 gradients. The
    (nh, N, N) bias gradient is scattered onto the table with ``index_add_``
    outside the kernel, as the JAX package's ``segment_sum`` is."""

    @staticmethod
    @profiling.spanned("K1")
    def forward(ctx, wins, ln, wqkv, bqkv, wproj, bproj, table, rel_index,
                grid_dims, window, shift, ln_eps, residual):
        dt = wins.dtype
        bias = gather_rel_bias(table, rel_index, wins.shape[1])
        ctx.save_for_backward(wins, ln, wqkv, bqkv, wproj, table, rel_index)
        ctx.geom = dict(grid_dims=grid_dims, window=window, shift=shift,
                        ln_eps=ln_eps, residual=residual)
        return window_attention(
            wins, wqkv.to(dt), None if bqkv is None else bqkv.float(),
            wproj.to(dt), bproj.float(), bias,
            ln=None if ln is None else ln.float(), **ctx.geom)

    @staticmethod
    def backward(ctx, dy):
        # unpacking may run a checkpointed block's recompute: outside K3
        wins, ln, wqkv, bqkv, wproj, table, rel_index = ctx.saved_tensors
        with profiling.span("K3"):
            dt = wins.dtype
            n, nh = wins.shape[1], table.shape[1]
            bias = gather_rel_bias(table, rel_index, n)
            dx, dwqkv, dbqkv, dwproj, dbproj, dbias, dln = \
                window_attention_bwd(
                    wins, wqkv.to(dt), None if bqkv is None else bqkv.float(),
                    wproj.to(dt), bias, dy.to(dt).contiguous(),
                    ln=None if ln is None else ln.float(), **ctx.geom)
            dtable = torch.zeros_like(table, dtype=torch.float32).index_add_(
                0, rel_index, dbias.permute(1, 2, 0).reshape(n * n, nh))
            return (dx, None if ln is None else dln.to(ln.dtype),
                    dwqkv.to(wqkv.dtype),
                    None if bqkv is None else dbqkv.to(bqkv.dtype),
                    dwproj.to(wproj.dtype), dbproj.to(wproj.dtype),
                    dtable.to(table.dtype), None, None, None, None, None,
                    None)
