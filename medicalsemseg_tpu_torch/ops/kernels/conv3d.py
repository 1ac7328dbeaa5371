"""3x3x3 / stride-1 / SAME convolution as an implicit GEMM over an im2col
tile: the wrapper of kernel K10, its plain PyTorch version and the autograd
function that joins forward, input gradient and weight gradient.

Replaces the TPU kernels of ``medicalsemseg_tpu/ops/pallas/conv3d.py``
(``conv3x3x3``: ``_conv_fwd``, ``_conv_dw`` and their custom VJP). As there,
no model calls it: the models' convolutions go to the library, and this
function stands beside them as the hand-written measure of it.

  forward  ``conv3x3x3_fwd``: y = conv(x, w), products of the inputs as they
           are, sums in fp32, one rounding to x's dtype (``csrc/conv3d.cu``;
           its header says how the kernel is built for the card);
  dx       the same kernel on dy with the spatially flipped, in / out
           swapped weights;
  dW       im2col(x)^T @ dy summed over every voxel is the function of
           kernel K5 (``ops.kernels.dw27``), which serves it: one kernel for
           both TPU functions, as K3 serves both attention backwards.

``x`` is channels-last (B, D, H, W, C), ``w`` in torch layout (Co, C, 3, 3, 3),
both bf16, fp16 or fp32, as the JAX function computes in ``x.dtype``. Two
routes (:func:`conv_route`): bf16 and fp16 run on the tensor cores
(``wgmma``, every output channel up to 128 in one block, the weights in the
layout of :func:`kernel_weights`), fp32 on the CUDA cores in fp32 FMA (TF32
would change the function). Both take any D, H, W and any channel counts
(the TPU kernel's rules C % 8, C <= 128, H >= 8, W % 8 and its bound on the
im2col scratch are rules of its layout), and so does K5.

A CPU tensor goes through :func:`conv3x3x3_plain`; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5
from medicalsemseg_tpu_torch.utils import profiling

# the output channels a tensor-core block may own (the widths csrc/conv3d.cu
# instantiates); wider Co takes further blocks
BLOCK_WIDTHS = (16, 32, 48, 64, 96, 128)
# input channels per wgmma k step and per staged chunk (kCK)
IN_CHANNEL_STEP = 16
CHUNK_CHANNELS = 48


def conv_route(dtype) -> str:
    """The route the dtype picks: the tensor cores for bf16 and fp16, the
    CUDA cores for fp32."""
    return "tensor_core" if kernels.tensor_core_dtype(dtype) else "cuda_core"


def block_width(co: int):
    """(N, blocks along Co) of the tensor-core route: the fewest blocks of
    at most 128 output channels, each as narrow as an instantiated width
    allows."""
    nz = -(-co // BLOCK_WIDTHS[-1])
    per = -(-co // nz)
    return min(n for n in BLOCK_WIDTHS if n >= per), nz


def kernel_weights(w: torch.Tensor, n: int) -> torch.Tensor:
    """(Co, C, 3, 3, 3) -> the tensor-core route's layout, zero padded, as
    (Co blocks, 27 CP n) with CP = C padded to 16: per Co block, per chunk of
    48 input channels (c0, its nks = ckp / 16 k steps), per tap (kd-major),
    per k step, [2 halves of 8 input channels][n output channels][8], so that
    one tap of one chunk is one contiguous copy laid out as the K-major core
    matrices wgmma reads (csrc/conv3d.cu):

        out[z, 27 c0 n + tap nks 16 n + ks 16 n + half 8 n + j 8 + e]
            = w[z n + j, c0 + 16 ks + 8 half + e, tap]."""
    co, c = w.shape[:2]
    step, chunk = IN_CHANNEL_STEP, CHUNK_CHANNELS
    cp = -(-c // step) * step
    nz = -(-co // n)
    wt = w.new_zeros((nz * n, cp, 27))
    wt[:co, :c] = w.reshape(co, c, 27)
    wt = wt.reshape(nz, n, cp, 27)
    parts = []
    for c0 in range(0, cp, chunk):
        nks = min(chunk, cp - c0) // step
        blk = wt[:, :, c0:c0 + nks * step].reshape(nz, n, nks, 2, 8, 27)
        parts.append(blk.permute(0, 5, 2, 3, 1, 4).reshape(nz, -1))
    return torch.cat(parts, dim=1).contiguous()


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


@profiling.spanned("K10")
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
    return _launch(x, w)


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's launch, whatever the device (the tests drive it on CPU
    tensors with a stand-in library)."""
    code = kernels.dtype_code("x", x.dtype)
    kernels.check_tensor("x", x, x.device, x.dtype)
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, expected {x.device}")
    route = conv_route(x.dtype)
    b, d, h, wd, c = x.shape
    co = w.shape[0]
    if route == "tensor_core":
        n, _ = block_width(co)
        wk = kernel_weights(w, n)
        cp = -(-c // IN_CHANNEL_STEP) * IN_CHANNEL_STEP
    else:
        # (27 taps, C, Co), kd-major
        wk = w.permute(2, 3, 4, 1, 0).reshape(27, c, co).contiguous()
        cp, n = c, co
    y = torch.empty((b, d, h, wd, co), dtype=x.dtype, device=x.device)

    lib = kernels.load()
    err = lib.medseg_conv3x3x3(
        kernels.ptr(x), kernels.ptr(wk), kernels.ptr(y), b, d, h, wd, c, co,
        cp, n, code, kernels.ROUTES[route], kernels.stream_handle(x.device))
    kernels.check(lib, err, "conv3x3x3")
    kernels.count_launch("K10", "forward", route)
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
