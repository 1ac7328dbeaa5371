"""SegFormer spatial-reduction attention: the wrapper of kernel K7 and its
plain PyTorch version.

Replaces the TPU kernel ``fused_sr_attention`` (``_kernel``) of
``medicalsemseg_tpu/ops/pallas/sr_attention.py``: over the N tokens, q dense
-> per-head softmax(q k^T * hd^-0.5) v against the M spatially reduced keys ->
proj [-> + shortcut], with K and V (B, M, C) precomputed by the caller.
Inference only, as on the TPU. The CUDA source is ``csrc/sr_attention.cu``;
its header says what bounds it on the card and how the design answers that.

The TPU wrapper's ``_tile_rows`` / ``fused_sr_attention_fits`` size a tile to
the TPU's fast memory and have no counterpart: a block is 32 tokens whatever
the width, and what the kernel takes is stated in :func:`sr_attention`. A CPU
tensor goes through :func:`sr_attention_plain`; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels.window_attention import MAX_HEAD_DIM

# kernel launches through sr_attention()
launches = 0


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
) -> torch.Tensor:
    """LayerNorm'ed tokens x (B, N, C) and precomputed k, v (B, M, C: the two
    halves of the kv dense output, head-major) -> proj(softmax(q k^T /
    sqrt(hd)) v) [+ residual], (B, N, C).

    ``x``, ``k`` and ``v`` are bf16, fp16 or fp32; ``wq`` and ``wproj`` (C,
    C) are [out, in] weights, cast to the activation dtype here as the JAX
    kernel casts them; ``bq`` (C,) or None and ``bproj`` (C,) are fp32;
    ``residual`` is the block's raw input (B, N, C), added in the activation
    dtype. The kernel takes any N (the last tile of 32 tokens is masked),
    head dims up to 32, and any M whose K and V fit a block's shared memory
    beside the token tile: M <= 75 at C = 384 in bf16, 34 in fp32, more at
    narrower widths (27 on every stage of the default model)."""
    if x.device.type == "cpu":
        return sr_attention_plain(x, k, v, wq, bq, wproj, bproj, num_heads,
                                  residual)
    if x.device.type != "cuda":
        raise ValueError(f"sr_attention: no kernel for {x.device}")

    b, n, c = x.shape
    m = k.shape[1]
    hd = c // num_heads
    if hd * num_heads != c or hd > MAX_HEAD_DIM:
        raise ValueError(f"C={c} with {num_heads} heads: head dim must divide "
                         f"C and be <= {MAX_HEAD_DIM}")
    dev, dt, f32 = x.device, x.dtype, torch.float32
    code = kernels.dtype_code("x", dt)
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
    smem = lib.medseg_sr_attention_smem_bytes(m, c, code)
    if smem > kernels.MAX_SMEM_BYTES:
        raise ValueError(f"M={m} reduced tokens at C={c} need {smem} bytes of "
                         f"shared memory, over {kernels.MAX_SMEM_BYTES}")
    out = torch.empty_like(x)
    err = lib.medseg_sr_attention_fwd(
        kernels.ptr(x), kernels.ptr(k), kernels.ptr(v), kernels.ptr(wq),
        kernels.ptr(bq), kernels.ptr(wproj), kernels.ptr(bproj),
        kernels.ptr(residual), kernels.ptr(out), b, n, m, c, num_heads, code,
        float(hd ** -0.5), kernels.stream_handle(dev))
    kernels.check(lib, err, "sr_attention")
    launches += 1
    return out
