"""3x3x3 / stride-1 / SAME convolution whose weight gradient can take kernel
K5 and whose forward and input gradient can take kernel K9 (counterpart of
medicalsemseg_tpu/ops/convgrad.py ``conv3x3x3_s1``).

Forward and input gradient are the library's convolution (cuDNN on the card),
as the JAX package leaves both to XLA, unless one of its two Winograd gates
is set; both are read at call time:

  ``MEDSEG_WINOGRAD=1``        without gradients (the JAX primal), an eligible
                               conv runs kernel K9 (``ops.kernels.winograd3d``,
                               F(2^3, 3^3)); ``models.layers.Conv3d`` asks
                               :func:`winograd_infer_eligible`. The JAX
                               package sends fp32 inputs to its F(4^3, 3^3)
                               formulation in XLA, which is not ported: fp32
                               keeps the library's conv here;
  ``MEDSEG_WINOGRAD_TRAIN=1``  with gradients, the forward value of
                               ``Conv3x3x3Fn`` and dx (K9 on dy with the
                               flipped, in / out swapped weights, gated on
                               dy's channel count) run K9; dW keeps its gate.

Eligible (:func:`wino23_eligible`): a bf16 tensor on the card whose channel
count lies in K9's window (16 <= C < 128).

The weight gradient goes through the JAX package's gate, read at call time
from ``MEDSEG_DW27_PALLAS``:

  unset / ``auto``  kernel K5 (``ops.kernels.dw27``) when the input has more
                    than 1.5M and at most 4M voxels (batch times volume) and
                    at least 16 channels: batches 2 to 4 of a 96^3 crop;
  ``1``             K5 whenever the input has at least 16 channels;
  ``0``             never;

otherwise the library's weight gradient (``aten.convolution_backward``, the
call behind ``torch.nn.grad.conv3d_weight``, which returns the input
gradient from the same call as autograd does). The JAX package's other
formulations (tap products in XLA, F(4^3, 3^3)) and its batch chunking
(``MEDSEG_DW27_CHUNK``: the chunks bound the TPU kernel's shifted copies of
x, which K5 does not make) have no counterpart here.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5
from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

# the auto window in voxels of the input, B * D * H * W (the JAX package's
# _DW27_MAX_VOXELS and _DW27_CHUNK_VOXELS)
DW27_AUTO_MIN_VOXELS = 1_500_000
DW27_AUTO_MAX_VOXELS = 4_000_000

_ONES, _ZEROS = (1, 1, 1), (0, 0, 0)


def dw27_mode() -> str:
    return os.environ.get("MEDSEG_DW27_PALLAS", "auto")


def dw27_eligible(shape) -> bool:
    """Whether the weight gradient of a conv over channels-last ``shape``
    (B, D, H, W, C) takes kernel K5; from the shape and the environment only."""
    mode = dw27_mode()
    if mode == "0":
        return False
    if mode == "1":
        want = True
    else:
        want = (DW27_AUTO_MIN_VOXELS < math.prod(shape[:-1])
                <= DW27_AUTO_MAX_VOXELS)
    return want and k5.dw27_applicable(tuple(shape[1:4]), shape[-1])


def _env_on(name: str) -> bool:
    return os.environ.get(name, "0") != "0"


def wino23_eligible(x: torch.Tensor) -> bool:
    """Whether a conv over channels-last ``x`` (B, D, H, W, C) can take
    kernel K9: bf16, on the card, channels inside the kernel's window."""
    return (x.dtype == torch.bfloat16
            and (x.is_cuda or k9.ALLOW_CPU)
            and k9.winograd_f23_applicable(tuple(x.shape[1:4]), x.shape[-1]))


def winograd_infer_eligible(x: torch.Tensor) -> bool:
    """``MEDSEG_WINOGRAD``: the no-gradient conv over ``x`` takes K9."""
    return _env_on("MEDSEG_WINOGRAD") and wino23_eligible(x)


def winograd_train_eligible(x: torch.Tensor) -> bool:
    """``MEDSEG_WINOGRAD_TRAIN``: under gradients, a conv over ``x`` (the
    forward's input, or dy for the input gradient) takes K9."""
    return _env_on("MEDSEG_WINOGRAD_TRAIN") and wino23_eligible(x)


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    # a contiguous (B, D, H, W, C) tensor seen as NCDHW is channels_last_3d
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


class Conv3x3x3Fn(torch.autograd.Function):
    """y = conv(x, w) for channels-last x (B, D, H, W, C) and a torch-layout
    weight w (Co, C, 3, 3, 3) of x's dtype -> (B, D, H, W, Co). The backward
    casts dy to x's dtype and returns dW in w's layout and dtype (a bf16
    model's dW is rounded to bf16 before it reaches the fp32 parameter, as
    with the library's own weight gradient). Kernel K9 has no backward of
    its own: its training path is this function's forward and dx."""

    @staticmethod
    def forward(ctx, x, w):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        if winograd_train_eligible(x):
            return k9.winograd_conv3d_f23(x, w)
        return _ndhwc(F.conv3d(_ncdhw(x), w, padding=1))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        need_x, need_w = ctx.needs_input_grad
        k9_dx = need_x and winograd_train_eligible(dy)
        lib_dx = need_x and not k9_dx
        lib_dw = need_w and not dw27_eligible(x.shape)
        dx = dw = None
        if lib_dx or lib_dw:
            dx, dw, _ = torch.ops.aten.convolution_backward(
                _ncdhw(dy), _ncdhw(x), w, None, _ONES, _ONES, _ONES, False,
                _ZEROS, 1, (lib_dx, lib_dw, False))
            dx = _ndhwc(dx) if lib_dx else None
        if k9_dx:
            dx = k9.winograd_conv3d_f23(dy, w.flip(2, 3, 4).transpose(0, 1))
        if need_w and not lib_dw:
            dw = k5.dw27(x, dy).permute(4, 3, 0, 1, 2).contiguous().to(w.dtype)
        return dx, dw
