"""Weight gradient of the 3x3x3 / stride-1 / SAME convolution: the wrapper of
kernel K5 and its plain PyTorch version.

Replaces the TPU kernel of ``medicalsemseg_tpu/ops/pallas/dw27.py``
(``dw27_pallas``): for channels-last ``x`` (B, D, H, W, C) and ``dy``
(B, D, H, W, Co),

    dw[kd, kh, kw, ci, co] = sum_{b,d,h,w} xpad[b, d+kd, h+kh, w+kw, ci]
                                           * dy[b, d, h, w, co]

with one voxel of zero padding, products of the inputs as they are and sums
in fp32. The CUDA source is ``csrc/dw27.cu``; its header says what bounds it
on the card and how the design answers that. It reads ``x`` from its own
layout (no shifted or channel-padded copies), so any batch runs in one call.
bf16 inputs with channel counts that are multiples of 8 run on tensor cores
(``wgmma``: a block owns the nine taps of one kd), everything else (fp16,
fp32, other channel counts) on CUDA cores; both add in fp32.

A CPU tensor goes through :func:`dw27_plain`; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.utils import profiling

# channels per block tile, voxels per spatial tile and dy rows per run of
# the tensor-core kernel (kCT, kWT, kHRun in csrc/dw27.cu)
TILE_CHANNELS = 48
TILE_VOXELS = 96
RUN_ROWS = 24
# csrc/dw27.cu medseg_dw27's routes
_ROUTES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 3}
_ROUTE_TENSOR_CORES = 2


def dw27_applicable(shape, cin: int) -> bool:
    """Whether the kernel is the route for a model's conv with ``cin`` input
    channels over a (D, H, W) volume (``ops.convgrad``): channels wide
    enough that the 27 tap products are matrix products and not outer
    products (the JAX package's rule). Its other rule, W a multiple of 8, is
    a TPU layout rule: this kernel bounds-checks every row and takes any W.
    It routes the models' convolutions and bounds nothing else: the kernel
    takes any channel count, as ``conv3x3x3``'s dW needs from 8 up."""
    del shape
    return cin >= 16


def dw27_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: 27 shifted slices of the
    padded input, each contracted with ``dy`` over the voxels in fp32.
    Returns (3, 3, 3, C, Co) fp32."""
    _, d, h, w, c = x.shape
    co = dy.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    dyf = dy.reshape(-1, co).float()
    taps = [xp[:, kd:kd + d, kh:kh + h, kw:kw + w].float().reshape(-1, c).t()
            @ dyf
            for kd in range(3) for kh in range(3) for kw in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, c, co)


def launch_shares(shape, co: int, route: int, device) -> int:
    """Blocks that split the voxels of one part of the accumulator (grid y
    of csrc/dw27.cu medseg_dw27) for x of ``shape`` (B, D, H, W, C)."""
    b, d, h, w, c = shape
    ctiles = -(-c // TILE_CHANNELS) * -(-co // TILE_CHANNELS)
    wtiles = -(-w // TILE_VOXELS)
    if route == _ROUTE_TENSOR_CORES:
        # one block of a kd and channel tile per SM (its __launch_bounds__),
        # each share walking runs of RUN_ROWS dy rows
        out_tiles, work = 3 * ctiles, b * d * -(-h // RUN_ROWS) * wtiles
        resident = kernels.resident_blocks(device) // 4
    else:
        # four blocks of a (kd, kh) and channel tile per SM, one W-row a tile
        out_tiles, work = 9 * ctiles, b * d * h * wtiles
        resident = kernels.resident_blocks(device)
    return max(1, min(work, resident // out_tiles))


@profiling.spanned("K5")
def dw27(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW of the 3^3 conv for ``x`` (B, D, H, W, C) and the output gradient
    ``dy`` (B, D, H, W, Co), both contiguous and both bf16, fp16 or fp32
    -> (3, 3, 3, C, Co) fp32."""
    if x.dim() != 5 or dy.dim() != 5 or dy.shape[:4] != x.shape[:4]:
        raise ValueError(f"dw27: x {tuple(x.shape)} and dy {tuple(dy.shape)} "
                         "are not (B, D, H, W, C) and (B, D, H, W, Co)")
    if x.device.type == "cpu":
        return dw27_plain(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"dw27: no kernel for {x.device}")
    return _launch(x, dy)


def _launch(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The kernel's launch, whatever the device (the tests drive it on CPU
    tensors with a stand-in library)."""
    b, d, h, w, c = x.shape
    co = dy.shape[-1]
    if x.dtype not in _ROUTES:
        raise ValueError(f"dw27: x is {x.dtype}, expected bfloat16, float16 "
                         "or float32")
    kernels.check_tensor("x", x, x.device, x.dtype)
    kernels.check_tensor("dy", dy, x.device, x.dtype)

    # the tensor-core kernel reads rows in 16-byte chunks of 8 bf16 values
    use_mma = x.dtype == torch.bfloat16 and c % 8 == 0 and co % 8 == 0
    route = _ROUTE_TENSOR_CORES if use_mma else _ROUTES[x.dtype]

    lib = kernels.load()
    shares = launch_shares(x.shape, co, route, x.device)
    part = torch.empty((shares, 27 * c * co), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((3, 3, 3, c, co), dtype=torch.float32, device=x.device)
    err = lib.medseg_dw27(
        kernels.ptr(x), kernels.ptr(dy), kernels.ptr(part), kernels.ptr(out),
        b, d, h, w, c, co, shares, route, kernels.stream_handle(x.device))
    kernels.check(lib, err, "dw27")
    # the tensor cores: bf16 with channels in 8s; the CUDA cores: the rest
    kernels.count_launch("K5", "backward",
                         "tensor_core" if use_mma else "cuda_core")
    return out
