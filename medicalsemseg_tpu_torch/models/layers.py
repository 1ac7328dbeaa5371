"""Shared layers (counterpart of medicalsemseg_tpu/models/layers.py).

Activations are channels-last (..., C) tensors in the model's compute dtype;
parameters stay fp32 and are cast at use, as the JAX modules do. Norm
statistics are fp32. For cuDNN, ``x.permute(0, 4, 1, 2, 3)`` of a contiguous
(B, D, H, W, C) tensor is already an NCDHW tensor in ``channels_last_3d``
memory format, so the convolutions copy nothing to change layout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from medicalsemseg_tpu_torch.ops.convgrad import Conv3x3x3Fn
from medicalsemseg_tpu_torch.ops.kernels import layer_norm
from medicalsemseg_tpu_torch.ops.kernels.mlp import FusedMlpFn, fused_mlp


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator] = None,
              keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample stochastic depth (timm DropPath semantics): each sample of
    the batch is kept with probability 1 - rate and scaled by 1 / keep.
    ``keep_mask`` (B,) bool replaces the draw (tests inject the mask that
    the JAX package drew)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    if keep_mask is None:
        keep_mask = torch.rand(x.shape[0], generator=generator,
                               device=x.device) < keep
    mask = keep_mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth on the residual branch. Draws from ``generator``
    when one is set (``set_generator``; it must live on the input's device),
    else from torch's global generator of that device."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor,
                keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return drop_path(x, self.rate, self.training, self.generator,
                         keep_mask)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and the fast variance
    (``ops.kernels.layer_norm``, the formula the kernels absorb)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def params(self) -> torch.Tensor:
        """(2, C) fp32 scale and bias rows, the form the kernels take."""
        return torch.stack([self.weight, self.bias]).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.float(), self.params(), self.eps).to(x.dtype)


class Conv3d(nn.Module):
    """Channels-last 3D convolution; weight (O, I, k, k, k) as in torch.

    1x1x1 / stride 1 runs as a matmul over the channel axis (the JAX
    package's ``_Fast1x1Conv``). 3x3x3 / stride 1 / SAME with gradients
    enabled goes through ``Conv3x3x3Fn`` (its ``_FastConv3dS1``), whose
    weight gradient may take kernel K5. Every other shape, and every shape
    without gradients, goes to cuDNN (oneDNN on the CPU) on the
    channels_last_3d view."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: Optional[int] = None,
                 bias: bool = True):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        # "SAME" for odd kernels at stride 1, as the JAX Conv3d default
        self.padding = kernel_size // 2 if padding is None else padding
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.kernel_size == 1 and self.stride == 1:
            return F.linear(x, self.weight[:, :, 0, 0, 0].to(dt), b)
        if (self.kernel_size == 3 and self.stride == 1 and self.padding == 1
                and torch.is_grad_enabled()):
            y = Conv3x3x3Fn.apply(x, self.weight.to(dt))
            return y if b is None else y + b
        y = F.conv3d(to_ncdhw(x), self.weight.to(dt), b, stride=self.stride,
                     padding=self.padding)
        return to_ndhwc(y)


class ConvTranspose3d(nn.Module):
    """Channels-last transposed conv with kernel == stride (no overlap).

    Weight (I, O, k, k, k) as in torch. The JAX model keeps the kernel
    spatially flipped relative to this layout (utils/torch_import.py
    ``conv_transpose``); ``utils.params`` converts between the two."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 bias: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(
            torch.empty(in_ch, out_ch, kernel_size, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv_transpose3d(to_ncdhw(x), self.weight.to(dt), b,
                               stride=self.kernel_size)
        return to_ndhwc(y)


class InstanceNorm(nn.Module):
    """Affine InstanceNorm over the spatial dims of (B, D, H, W, C), fp32
    statistics (population variance)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(1, 2, 3), keepdim=True,
                                   correction=0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 token MLP, run as the fused kernels with the
    block's pre-MLP LayerNorm absorbed: K2 alone without gradients (the JAX
    block's inference form with Pallas on), K2 forward + K4 backward through
    ``FusedMlpFn`` with them (its ``fused_mlp_trainable``)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, ln: torch.Tensor,
                residual: bool = True) -> torch.Tensor:
        """[x +] mlp(LN(x)) for raw tokens x (M, C) in the compute dtype,
        with the LayerNorm's (2, C) scale/bias rows ``ln``."""
        if torch.is_grad_enabled():
            return FusedMlpFn.apply(x.contiguous(), ln, self.fc1.weight,
                                    self.fc1.bias, self.fc2.weight,
                                    self.fc2.bias, 1e-5, residual)
        dt = x.dtype
        return fused_mlp(x.contiguous(), self.fc1.weight.to(dt),
                         self.fc1.bias.float(), self.fc2.weight.to(dt),
                         self.fc2.bias.float(), ln=ln, residual=residual)

