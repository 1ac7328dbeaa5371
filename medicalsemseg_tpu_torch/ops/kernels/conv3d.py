"""3x3x3 / stride-1 / SAME convolution as an implicit GEMM over an im2col
tile: the wrapper of kernel K10, its plain PyTorch version and the autograd
function that joins forward, input gradient and weight gradient.

Replaces the TPU kernels of ``medicalsemseg_tpu/ops/pallas/conv3d.py``
(``conv3x3x3``: ``_conv_fwd``, ``_conv_dw`` and their custom VJP). As there,
no model calls it: the models' convolutions go to the library, and this
function stands beside them as the hand-written measure of it.

  forward  ``conv3x3x3_fwd``: y = conv(x, w), products of the inputs as they
           are, sums in fp32, one rounding to x's dtype (``csrc/conv3d.cu``;
           its header says what bounds it on the card);
  dx       the same kernel on dy with the spatially flipped, in / out
           swapped weights;
  dW       im2col(x)^T @ dy summed over every voxel is the function of
           kernel K5 (``ops.kernels.dw27``), which serves it: one kernel for
           both TPU functions, as K3 serves both attention backwards.

``x`` is channels-last (B, D, H, W, C), ``w`` in torch layout (Co, C, 3, 3, 3).
The kernel takes bf16 tensors of any D, H, W and any channel counts (the TPU
kernel's rules C % 8, C <= 128, H >= 8, W % 8 and its bound on the im2col
scratch are rules of its layout); K5 wants at least 16 input channels.

A CPU tensor goes through :func:`conv3x3x3_plain`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5
from medicalsemseg_tpu_torch.ops.kernels.winograd3d import pad_kernel_weights

# kernel launches through conv3x3x3_fwd() (forward and input gradient)
launches = 0


def conv3x3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: 27 shifted slices of the
    padded input, each multiplied by its tap's (C, Co) matrix, added in
    fp32 and rounded once."""
    b, d, h, wd, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    wf = w.float()
    y = None
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                t = (xp[:, kd:kd + d, kh:kh + h, kw:kw + wd].float()
                     @ wf[:, :, kd, kh, kw].t())
                y = t if y is None else y + t
    return y.to(x.dtype)


def conv3x3x3_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y (B, D, H, W, Co) = conv(x (B, D, H, W, C), w (Co, C, 3, 3, 3)),
    both of one dtype."""
    if x.dim() != 5 or tuple(w.shape[1:]) != (x.shape[-1], 3, 3, 3):
        raise ValueError(f"conv3x3x3: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (B, D, H, W, C) and "
                         "(Co, C, 3, 3, 3)")
    if w.dtype != x.dtype:
        raise ValueError(f"conv3x3x3: w is {w.dtype}, x is {x.dtype}")
    if x.device.type == "cpu":
        return conv3x3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3x3: no kernel for {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"conv3x3x3: x is {x.dtype}, the kernel takes "
                         "bfloat16")
    kernels.check_tensor("x", x, x.device, torch.bfloat16)
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, expected {x.device}")

    b, d, h, wd, c = x.shape
    co = w.shape[0]
    # (27 taps, Co, C), kd-major, then the kernels' padded (27, CoP, CP)
    wk = pad_kernel_weights(w.permute(2, 3, 4, 0, 1).reshape(27, co, c))
    y = torch.empty((b, d, h, wd, co), dtype=x.dtype, device=x.device)

    global launches
    lib = kernels.load()
    err = lib.medseg_conv3x3x3(
        kernels.ptr(x), kernels.ptr(wk), kernels.ptr(y), b, d, h, wd, c, co,
        wk.shape[2], wk.shape[1], kernels.stream_handle(x.device))
    kernels.check(lib, err, "conv3x3x3")
    launches += 1
    return y


def flip_weights(w: torch.Tensor) -> torch.Tensor:
    """The weights of the input gradient: spatially flipped, in and out
    swapped, (Co, C, 3, 3, 3) -> (C, Co, 3, 3, 3)."""
    return w.flip(2, 3, 4).transpose(0, 1)


class Im2colConv3dFn(torch.autograd.Function):
    """conv3x3x3 with its three parts; the backward casts dy to x's dtype
    and returns dW in w's layout and dtype."""

    @staticmethod
    def forward(ctx, x, w):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        return conv3x3x3_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3x3_fwd(dy, flip_weights(w))
        if ctx.needs_input_grad[1]:
            dw = k5.dw27(x, dy).permute(4, 3, 0, 1, 2).contiguous().to(w.dtype)
        return dx, dw


def conv3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME, stride-1, channels-last 3^3 conv with kernel K10 forward and
    backward (dW through K5)."""
    return Im2colConv3dFn.apply(x, w)
