"""Fused token MLP (forward): the wrapper of kernel K2 and its plain PyTorch
version.

Replaces the TPU kernel ``medicalsemseg_tpu/ops/pallas/mlp.py``
``fused_mlp`` (``_kernel``): [LN ->] fc1 -> exact GELU -> fc2 [-> +x], with
the (M, 4C) hidden activations kept on chip. The CUDA source is
``csrc/mlp.cu``; its header says what bounds it on the card and how the
design answers that.

A CPU tensor goes through :func:`fused_mlp_plain`; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.ops import kernels

# kernel launches through fused_mlp()
launches = 0

# shared memory per block grows with C and Co (csrc/mlp.cu): 203 KB of the
# 227 KB limit at C = Co = 512
MAX_WIDTH = 512


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
