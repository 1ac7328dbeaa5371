"""SegFormer spatial-reduction attention: the wrapper of kernel K7 and its
plain PyTorch version.

Replaces the TPU kernel ``fused_sr_attention`` (``_kernel``) of
``medicalsemseg_tpu/ops/pallas/sr_attention.py``: over the N tokens, q dense
-> per-head softmax(q k^T * hd^-0.5) v against the M spatially reduced keys ->
proj [-> + shortcut], with K and V (B, M, C) precomputed by the caller.
Inference only, as on the TPU. The CUDA source is ``csrc/sr_attention.cu``;
its header says what bounds it on the card and how the design answers that.

Two routes, picked by :func:`sr_route` from the dtype and the shape alone:
the tensor cores (``mma.sync``; bf16 and fp16 at head dim 16 with at most 64
reduced keys and C <= 384: every SegFormer3D stage) and the CUDA cores
(fp32, whose agreement with the fp32 plain path TF32 would cost, other head
dims, more keys or wider C). :func:`sr_plan` gives the tensor-core launch its
token tile, its head groups (the blocks of a thread-block cluster that add
their partial projections) and its token slots; the CUDA-core launch plans
itself in C (``sr_cc_plan``: its token tile, its chunk of reduced keys, as K
and V stream through shared memory so that any M runs, and its projection
chunk). A failed launch raises; nothing falls back to the other route.

The TPU wrapper's ``_tile_rows`` / ``fused_sr_attention_fits`` size a tile to
the TPU's fast memory and have no counterpart. :func:`sr_attention_supported`
says from the dtype and the shape alone whether a route takes a launch: head
dims up to 32 (ROADMAP R15 is the kernel work above), C up to 768 and at
most 64 heads, any M. A CPU tensor goes through :func:`sr_attention_plain`;
a CUDA tensor launches a kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels.window_attention import MAX_HEAD_DIM

# kernel launches through sr_attention(), and the same by route
launches = 0
ROUTES = kernels.ROUTES
route_launches = dict.fromkeys(ROUTES, 0)

# the tensor-core route (csrc/sr_attention.cu): head dim 16, at most 64
# reduced keys and 24 heads (C <= 384); a block owns a group of at most 6
# heads, a cluster at most 8 groups; token tiles of at most 64 rows
TC_HEAD_DIM = 16
TC_MAX_KEYS = 64
TC_MAX_HEADS = 24
TC_MAX_GROUP_HEADS = 6
TC_MAX_GROUPS = 8
TC_MAX_ROWS = 64
# what the CUDA-core route takes at any M (csrc/sr_attention.cu sr_cc_plan):
# its smallest plan (16 token rows, 8 keys a chunk, 16 projection columns)
# fits a block up to C = 768 with 64 heads in fp32
MAX_WIDTH = 768
MAX_HEADS = 64


def sr_route(dtype, c: int, num_heads: int, m: int) -> str:
    """The route of a launch: ``"tensor_core"`` for bf16 and fp16 at head dim
    16 with 1 <= M <= 64 reduced keys and at most 24 heads, else
    ``"cuda_core"``."""
    if (kernels.tensor_core_dtype(dtype) and c == TC_HEAD_DIM * num_heads
            and num_heads <= TC_MAX_HEADS and 1 <= m <= TC_MAX_KEYS):
        return "tensor_core"
    return "cuda_core"


def pick_route(route: Optional[str], dtype, c: int, num_heads: int,
               m: int) -> str:
    """``route`` if given (it must be one K7 takes for this dtype and
    shape), else :func:`sr_route`."""
    return kernels.pick_route(route, sr_route(dtype, c, num_heads, m),
                              f"{dtype} with C={c}, {num_heads} heads and "
                              f"M={m} (K7)")


def sr_tc_smem_bytes(rows: int, c: int, num_heads: int, groups: int, m: int,
                     slots: int, residual: bool) -> int:
    """Dynamic shared memory of a tensor-core block (csrc/sr_attention.cu
    sr_tc_smem_bytes): ``slots`` token tiles of ``rows`` x (C + 8) (with one
    group and the shortcut, as many of the shortcut's), the group's Wq rows
    and Wproj columns, K and V of its heads over M padded to 16s, all in
    2-byte elements, and with several groups the fp32 partial projection of
    a tile."""
    hg = -(-num_heads // groups)
    xs, ps, mp = c + 8, 16 * hg + 8, 16 * -(-m // 16)
    tiles = 2 * slots if groups == 1 and residual else slots
    elems = tiles * rows * xs + 16 * hg * xs + c * ps + 2 * mp * ps
    return 2 * elems + (4 * rows * xs if groups > 1 else 0)


@functools.lru_cache(maxsize=None)
def sr_plan(b: int, n: int, c: int, num_heads: int, m: int, sms: int,
            residual: bool = True):
    """(rows, groups, slots) of a tensor-core launch: token tiles of up to 64
    rows; the fewest head groups that keep a group at <= 6 heads and, with
    one cluster of ``groups`` blocks per tile, put a block on at least 7/8 of
    the ``sms`` SMs (stage 4 of SegFormer3D: 16 single-tile batch elements
    x 8 groups; stage 3: 64 tiles x 2); then the most rows and slots (2: the
    next tile in flight) whose shared memory fits a block."""
    rows0 = min(TC_MAX_ROWS, 16 * -(-n // 16))
    top = min(TC_MAX_GROUPS, num_heads)
    groups = -(-num_heads // TC_MAX_GROUP_HEADS)
    while groups < top and b * -(-n // rows0) * groups < sms - sms // 8:
        groups += 1
    for g in range(groups, top + 1):
        for rows in sorted({rows0, min(rows0, 32), 16}, reverse=True):
            for slots in (2, 1):
                if (sr_tc_smem_bytes(rows, c, num_heads, g, m, slots,
                                     residual) <= kernels.MAX_SMEM_BYTES):
                    return rows, g, slots
    raise ValueError(f"K7: no tensor-core plan for C={c}, {num_heads} heads, "
                     f"M={m}")


@functools.lru_cache(maxsize=None)
def sr_attention_supported(dtype, c: int, num_heads: int, m: int) -> bool:
    """Whether a route of K7 takes tokens of width C over ``num_heads``
    heads against M reduced keys in ``dtype``: bf16, fp16 or fp32, a head
    dim that divides C and is at most 32, C <= 768, at most 64 heads, any M
    (the tensor-core route takes a subset). Pure: calls no library."""
    if dtype not in (torch.bfloat16, torch.float16, torch.float32):
        return False
    hd = c // num_heads if num_heads > 0 else 0
    return (1 <= hd <= MAX_HEAD_DIM and hd * num_heads == c
            and c <= MAX_WIDTH and num_heads <= MAX_HEADS and m >= 1)


def _heads(a: torch.Tensor, nh: int) -> torch.Tensor:
    b, n, c = a.shape
    return a.reshape(b, n, nh, c // nh).permute(0, 2, 1, 3)


def sr_attention_plain(
    x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, wq: torch.Tensor,
    bq: Optional[torch.Tensor], wproj: torch.Tensor, bproj: torch.Tensor,
    num_heads: int, residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, rounding to ``x.dtype`` at the
    kernel's points and accumulating in fp32."""
    dt = x.dtype
    b, n, c = x.shape
    q = x.float() @ wq.to(dt).float().t()
    if bq is not None:
        q = q + bq.float()
    q = _heads(q.to(dt).float(), num_heads)
    kh, vh = _heads(k.to(dt).float(), num_heads), _heads(v.to(dt).float(),
                                                         num_heads)
    # logits in fp32, scaled after the dot
    attn = (q @ kh.transpose(-1, -2)) * (c // num_heads) ** -0.5
    p = torch.softmax(attn, dim=-1).to(dt).float()
    out = (p @ vh).permute(0, 2, 1, 3).reshape(b, n, c).to(dt)
    out = (out.float() @ wproj.to(dt).float().t() + bproj.float()).to(dt)
    if residual is not None:
        out = out + residual
    return out


def sr_attention(
    x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, wq: torch.Tensor,
    bq: Optional[torch.Tensor], wproj: torch.Tensor, bproj: torch.Tensor,
    num_heads: int, residual: Optional[torch.Tensor] = None,
    route: Optional[str] = None,
) -> torch.Tensor:
    """LayerNorm'ed tokens x (B, N, C) and precomputed k, v (B, M, C: the two
    halves of the kv dense output, head-major) -> proj(softmax(q k^T /
    sqrt(hd)) v) [+ residual], (B, N, C).

    ``x``, ``k`` and ``v`` are bf16, fp16 or fp32; ``wq`` and ``wproj`` (C,
    C) are [out, in] weights, cast to the activation dtype here as the JAX
    kernel casts them; ``bq`` (C,) or None and ``bproj`` (C,) are fp32;
    ``residual`` is the block's raw input (B, N, C), added in the activation
    dtype. Both routes take any N (the last token tile is masked). The
    tensor-core route takes what :func:`sr_route` gives it (every stage of
    the default model: M = 27); the CUDA-core route head dims up to 32 and
    any M (K and V stream in chunks) at widths up to ~900. ``route``
    forces one (``"cuda_core"`` always; ``"tensor_core"`` only where
    :func:`sr_route` gives it)."""
    if x.device.type == "cpu":
        return sr_attention_plain(x, k, v, wq, bq, wproj, bproj, num_heads,
                                  residual)
    if x.device.type != "cuda":
        raise ValueError(f"sr_attention: no kernel for {x.device}")
    return _launch(x, k, v, wq, bq, wproj, bproj, num_heads, residual, route)


def _launch(x, k, v, wq, bq, wproj, bproj, num_heads, residual, route):
    """Check the tensors, pick the route and launch (any device: the CPU
    tests drive this path with a stand-in library)."""
    b, n, c = x.shape
    m = k.shape[1]
    hd = c // num_heads
    if hd * num_heads != c or hd > MAX_HEAD_DIM:
        raise ValueError(f"C={c} with {num_heads} heads: head dim must divide "
                         f"C and be <= {MAX_HEAD_DIM}")
    dev, dt, f32 = x.device, x.dtype, torch.float32
    code = kernels.dtype_code("x", dt)
    route = pick_route(route, dt, c, num_heads, m)
    wq, wproj = wq.to(dt), wproj.to(dt)
    kernels.check_tensor("x", x, dev, dt)
    kernels.check_tensor("k", k, dev, dt, (b, m, c))
    kernels.check_tensor("v", v, dev, dt, (b, m, c))
    kernels.check_tensor("wq", wq, dev, dt, (c, c))
    kernels.check_tensor("wproj", wproj, dev, dt, (c, c))
    kernels.check_tensor("bproj", bproj, dev, f32, (c,))
    if bq is not None:
        kernels.check_tensor("bq", bq, dev, f32, (c,))
    if residual is not None:
        kernels.check_tensor("residual", residual, dev, dt, (b, n, c))

    global launches
    lib = kernels.load()
    rows = groups = slots = 0
    if route == "tensor_core":
        rows, groups, slots = sr_plan(b, n, c, num_heads, m,
                                      kernels.sm_count(dev),
                                      residual is not None)
        kernels.check_aligned(x=x, k=k, v=v, wq=wq, wproj=wproj,
                              **({} if residual is None
                                 else {"residual": residual}))
    else:
        smem = lib.medseg_sr_attention_smem_bytes(m, c, num_heads, code)
        if smem > kernels.MAX_SMEM_BYTES:
            raise ValueError(f"C={c} with {num_heads} heads needs {smem} "
                             f"bytes of shared memory, over "
                             f"{kernels.MAX_SMEM_BYTES}")
    out = torch.empty_like(x)
    err = lib.medseg_sr_attention_fwd(
        kernels.ptr(x), kernels.ptr(k), kernels.ptr(v), kernels.ptr(wq),
        kernels.ptr(bq), kernels.ptr(wproj), kernels.ptr(bproj),
        kernels.ptr(residual), kernels.ptr(out), b, n, m, c, num_heads, rows,
        groups, slots, ROUTES[route], code, float(hd ** -0.5),
        kernels.stream_handle(dev))
    kernels.check(lib, err, "sr_attention")
    launches += 1
    route_launches[route] += 1
    return out
