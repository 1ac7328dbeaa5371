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
(``mma.sync``), everything else on CUDA cores; both add in fp32.

A CPU tensor goes through :func:`dw27_plain`; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.ops import kernels

# kernel launches through dw27()
launches = 0

# channels per block tile and voxels per spatial tile (kCT, kWT in csrc/dw27.cu)
TILE_CHANNELS = 48
TILE_VOXELS = 96


def dw27_applicable(shape, cin: int) -> bool:
    """Whether the kernel is the route for a conv with ``cin`` input channels
    over a (D, H, W) volume: channels wide enough that the 27 tap products
    are matrix products and not outer products (the JAX package's rule).
    Its other rule, W a multiple of 8, is a TPU layout rule: this kernel
    bounds-checks every row and takes any W."""
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


def dw27(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW of the 3^3 conv for ``x`` (B, D, H, W, C) and the output gradient
    ``dy`` (B, D, H, W, Co), both contiguous and both bf16 or both fp32
    -> (3, 3, 3, C, Co) fp32."""
    if x.dim() != 5 or dy.dim() != 5 or dy.shape[:4] != x.shape[:4]:
        raise ValueError(f"dw27: x {tuple(x.shape)} and dy {tuple(dy.shape)} "
                         "are not (B, D, H, W, C) and (B, D, H, W, Co)")
    if x.device.type == "cpu":
        return dw27_plain(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"dw27: no kernel for {x.device}")

    b, d, h, w, c = x.shape
    co = dy.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dw27: x is {x.dtype}, expected bfloat16 or float32")
    if not dw27_applicable((d, h, w), c):
        raise ValueError(f"dw27: {c} input channels, the kernel takes >= 16")
    kernels.check_tensor("x", x, x.device, x.dtype)
    kernels.check_tensor("dy", dy, x.device, x.dtype)

    # the tensor-core kernel reads rows in 16-byte chunks of 8 bf16 values
    use_mma = x.dtype == torch.bfloat16 and c % 8 == 0 and co % 8 == 0
    route = 2 if use_mma else int(x.dtype == torch.bfloat16)

    global launches
    lib = kernels.load()
    out_tiles = 9 * -(-c // TILE_CHANNELS) * -(-co // TILE_CHANNELS)
    voxel_tiles = b * d * h * -(-w // TILE_VOXELS)
    # blocks that fit an SM at once: 4 of the CUDA-core kernel, 3 of the
    # larger tensor-core one (their __launch_bounds__ in csrc/dw27.cu)
    resident = kernels.resident_blocks(x.device) * (3 if use_mma else 4) // 4
    shares = max(1, min(voxel_tiles, resident // out_tiles))
    part = torch.empty((shares, 27 * c * co), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((3, 3, 3, c, co), dtype=torch.float32, device=x.device)
    err = lib.medseg_dw27(
        kernels.ptr(x), kernels.ptr(dy), kernels.ptr(part), kernels.ptr(out),
        b, d, h, w, c, co, shares, route, kernels.stream_handle(x.device))
    kernels.check(lib, err, "dw27")
    launches += 1
    return out
