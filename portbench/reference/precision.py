"""The arithmetic of the reference's products.

The reference models compute every product (dense layer, convolution,
transposed convolution, attention matmul) through one of these objects:

* :data:`EXACT`: plain fp32 PyTorch. The caller turns TF32 off
  (:func:`no_tf32`), so fp32 means fp32 on the card too.
* :class:`Fp8`: the control. Both operands of every product are rounded to
  float8 e4m3 with one scale per tensor (its absolute maximum onto e4m3's
  largest normal, 448) and the product is taken in fp32 from the rounded
  values; in the backward the incoming gradient is rounded to e5m2 the same
  way. That is the step below the configurations' bf16, which a later change
  could be tempted to take, and it has to fail the comparison.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


@contextlib.contextmanager
def no_tf32():
    """fp32 matmuls and convolutions in true fp32 inside the block."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


class Exact:
    """fp32 products."""

    def linear(self, x, w, b=None):
        return F.linear(x, w, b)

    def conv3d(self, x, w, b=None, stride=1, padding=0):
        return F.conv3d(x, w, b, stride=stride, padding=padding)

    def conv_transpose3d(self, x, w, stride):
        return F.conv_transpose3d(x, w, None, stride=stride)

    def matmul(self, a, b):
        return torch.matmul(a, b)


EXACT = Exact()


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (t.float() * scale).to(dtype).float() / scale


class _Fp8Round(torch.autograd.Function):
    """e4m3 in the forward, e5m2 on the gradient, per-tensor scales."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8Round.apply(t)


class Fp8(Exact):
    """Every product on fp8-rounded operands (the control)."""

    def linear(self, x, w, b=None):
        return F.linear(fp8(x), fp8(w), b)

    def conv3d(self, x, w, b=None, stride=1, padding=0):
        return F.conv3d(fp8(x), fp8(w), b, stride=stride, padding=padding)

    def conv_transpose3d(self, x, w, stride):
        return F.conv_transpose3d(fp8(x), fp8(w), None, stride=stride)

    def matmul(self, a, b):
        return torch.matmul(fp8(a), fp8(b))


PRECISIONS = {"fp32": EXACT, "fp8": Fp8()}
