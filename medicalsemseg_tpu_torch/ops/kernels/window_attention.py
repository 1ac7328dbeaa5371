"""Fused 3D window attention (forward): the wrapper of kernel K1 and its plain
PyTorch version.

Replaces the TPU kernel ``medicalsemseg_tpu/ops/pallas/window_attention.py``
``fused_window_attention`` (``_kernel`` + ``_window_mask``). The CUDA source
is ``csrc/window_attention.cu``; its header says what bounds it on the card
and how the design answers that.

:func:`window_attention` takes windows that were already partitioned (and,
for a shifted block, cyclically rolled by -shift) in batch-major window
order, and returns the attention output windows. A CPU tensor goes through
:func:`window_attention_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.window import _shift_mask_np

Tuple3 = Tuple[int, int, int]

# kernel launches through window_attention() (one per call; the call is two
# CUDA launches: heads, then projection)
launches = 0

MAX_HEAD_DIM = 32


def window_attention_plain(
    wins: torch.Tensor, wqkv: torch.Tensor, bqkv: Optional[torch.Tensor],
    wproj: torch.Tensor, bproj: torch.Tensor, bias: torch.Tensor, *,
    grid_dims: Tuple3, window: Tuple3, shift: Tuple3,
    ln: Optional[torch.Tensor] = None, ln_eps: float = 1e-5,
    residual: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, rounding to ``wins.dtype`` at
    the kernel's points and accumulating in fp32. The shifted-window mask
    comes from the region grid (``_shift_mask_np``), independently of the
    kernel's per-token label formula."""
    dt = wins.dtype
    t, n, c = wins.shape
    nh = bias.shape[0]
    hd = c // nh
    xf = wins.float()
    xn = kernels.layer_norm(xf, ln, ln_eps).to(dt) if ln is not None else wins
    qkv = xn.float() @ wqkv.to(dt).float().t()
    if bqkv is not None:
        qkv = qkv + bqkv.float()
    qkv = qkv.to(dt).float().reshape(t, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                   # (T, nh, N, hd)
    attn = (q @ k.transpose(-1, -2)) * (hd ** -0.5) + bias.float()[None]
    if any(s > 0 for s in shift):
        if len(set(window)) != 1 or len(set(shift)) != 1:
            raise NotImplementedError("plain mask needs a cubic window/shift")
        dims = tuple(g * w for g, w in zip(grid_dims, window))
        mask = torch.from_numpy(_shift_mask_np(dims, window[0], shift[0]))
        nw = mask.shape[0]
        attn = (attn.reshape(t // nw, nw, nh, n, n)
                + mask.to(attn.device)[None, :, None]).reshape(t, nh, n, n)
    p = torch.softmax(attn, dim=-1).to(dt).float()
    out = (p @ v).permute(0, 2, 1, 3).reshape(t, n, c).to(dt)
    out = (out.float() @ wproj.to(dt).float().t() + bproj.float()).to(dt)
    if residual:
        out = out + wins
    return out


def window_attention(
    wins: torch.Tensor, wqkv: torch.Tensor, bqkv: Optional[torch.Tensor],
    wproj: torch.Tensor, bproj: torch.Tensor, bias: torch.Tensor, *,
    grid_dims: Tuple3, window: Tuple3, shift: Tuple3,
    ln: Optional[torch.Tensor] = None, ln_eps: float = 1e-5,
    residual: bool = False,
) -> torch.Tensor:
    """Windows (T, N, C) -> attention output windows (T, N, C).

    ``wqkv`` (3C, C) and ``wproj`` (C, C) are [out, in] weights in the
    activation dtype; ``bqkv`` (3C,), ``bproj`` (C,), ``ln`` (2, C) scale and
    bias rows, and the gathered relative-position ``bias`` (nh, N, N) are
    fp32. ``grid_dims`` is the window grid (nwd, nwh, nww) of one volume, so
    T = B * nwd * nwh * nww. With ``ln`` the windows are raw and the kernel
    applies the block's LayerNorm; with ``residual`` it adds the raw windows.
    """
    kw = dict(grid_dims=tuple(grid_dims), window=tuple(window),
              shift=tuple(shift), ln=ln, ln_eps=ln_eps, residual=residual)
    if wins.device.type == "cpu":
        return window_attention_plain(wins, wqkv, bqkv, wproj, bproj, bias, **kw)
    if wins.device.type != "cuda":
        raise ValueError(f"window_attention: no kernel for {wins.device}")

    t, n, c = wins.shape
    nh = bias.shape[0]
    hd = c // nh
    nwin = grid_dims[0] * grid_dims[1] * grid_dims[2]
    if n != window[0] * window[1] * window[2] or t % nwin != 0:
        raise ValueError(f"windows {tuple(wins.shape)} do not match window "
                         f"{window} / grid {grid_dims}")
    if hd * nh != c or hd > MAX_HEAD_DIM:
        raise ValueError(f"C={c} with {nh} heads: head dim must divide C and "
                         f"be <= {MAX_HEAD_DIM}")
    dev, bf, f32 = wins.device, torch.bfloat16, torch.float32
    kernels.check_tensor("wins", wins, dev, bf)
    kernels.check_tensor("wqkv", wqkv, dev, bf, (3 * c, c))
    kernels.check_tensor("wproj", wproj, dev, bf, (c, c))
    kernels.check_tensor("bproj", bproj, dev, f32, (c,))
    kernels.check_tensor("bias", bias, dev, f32, (nh, n, n))
    if bqkv is not None:
        kernels.check_tensor("bqkv", bqkv, dev, f32, (3 * c,))
    if ln is not None:
        kernels.check_tensor("ln", ln, dev, f32, (2, c))

    global launches
    lib = kernels.load()
    attn = torch.empty_like(wins)
    out = torch.empty_like(wins)
    shifted = int(any(s > 0 for s in shift))
    err = lib.medseg_window_attention_fwd(
        kernels.ptr(wins), kernels.ptr(ln), kernels.ptr(wqkv),
        kernels.ptr(bqkv), kernels.ptr(wproj), kernels.ptr(bproj),
        kernels.ptr(bias), kernels.ptr(attn), kernels.ptr(out),
        t, n, c, nh, *window, *shift, *grid_dims, shifted, int(residual),
        float(ln_eps), float(hd ** -0.5), kernels.stream_handle(dev))
    kernels.check(lib, err, "window_attention")
    launches += 1
    return out
