"""3x3x3 / stride-1 / SAME convolution whose weight gradient can take kernel
K5 (counterpart of medicalsemseg_tpu/ops/convgrad.py ``conv3x3x3_s1``).

Forward and input gradient are the library's convolution (cuDNN on the card),
as the JAX package leaves both to XLA. The weight gradient goes through the
JAX package's gate, read at call time from ``MEDSEG_DW27_PALLAS``:

  unset / ``auto``  kernel K5 (``ops.kernels.dw27``) when the input has more
                    than 1.5M and at most 4M voxels (batch times volume) and
                    at least 16 channels: batches 2 to 4 of a 96^3 crop;
  ``1``             K5 whenever the input has at least 16 channels;
  ``0``             never;

otherwise the library's weight gradient (``aten.convolution_backward``, the
call behind ``torch.nn.grad.conv3d_weight``, which returns the input
gradient from the same call as autograd does). The JAX package's other
formulations (tap products in XLA, Winograd) and its batch chunking
(``MEDSEG_DW27_CHUNK``: the chunks bound the TPU kernel's shifted copies of
x, which K5 does not make) have no counterpart here.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5

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
    with the library's own weight gradient)."""

    @staticmethod
    def forward(ctx, x, w):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        return _ndhwc(F.conv3d(_ncdhw(x), w, padding=1))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        need_x, need_w = ctx.needs_input_grad
        use_k5 = need_w and dw27_eligible(x.shape)
        dx = dw = None
        if need_x or (need_w and not use_k5):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                _ncdhw(dy), _ncdhw(x), w, None, _ONES, _ONES, _ONES, False,
                _ZEROS, 1, (need_x, need_w and not use_k5, False))
        if use_k5:
            dw = k5.dw27(x, dy).permute(4, 3, 0, 1, 2).contiguous().to(w.dtype)
        return (_ndhwc(dx) if need_x else None), dw
