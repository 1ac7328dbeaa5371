"""FocalNet 3D encoder (counterpart of medicalsemseg_tpu/models/focalnet.py):
attention-free focal modulation blocks over (B, D, H, W, C) volumes.

Each block's modulation is a dense layer to (q, context, gates), a
hierarchy of depthwise convolutions with exact GELU over the context (kernel
``focal_factor * k + focal_window`` at level k: 6 and 8 at the default
window 6, even kernels with flax's "SAME" padding), a global context from the
mean of the last level, the gated sum, a 1x1 convolution and q times it.
The depthwise convolutions are PyTorch's own, as the JAX package leaves them
to XLA. The MLP after LN2 runs kernel K2 with the LayerNorm absorbed in
``eval()`` mode (the JAX block's inference form: ``residual=True``, or
``x + gamma_2 * mlp`` under layer-scale; with gradients enabled K2 forward and
K4 backward), and plain PyTorch with DropPath in training, as the JAX block
runs XLA there. Module names follow the JAX scopes (``layers.{i}.blocks.{j}
.modulation.focal_layers.{k}``, ``layers.{i}.downsample``, ``norm{i}``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medicalsemseg_tpu_torch.models.embeddings import PatchEmbed3D
from medicalsemseg_tpu_torch.models.layers import (
    Conv3d,
    DropPath,
    LayerNorm,
    Mlp,
    linear,
)

Tuple3 = Tuple[int, int, int]


class FocalModulation(nn.Module):
    """f: dense to 2C + L + 1 -> (q, ctx, gates); L levels of depthwise conv
    + GELU, each added gated; GELU of the mean of the last level over (D, H,
    W), added gated; out = proj(q * h(ctx_all)), all in the compute dtype."""

    def __init__(self, dim: int, focal_level: int = 2, focal_window: int = 7,
                 focal_factor: int = 2):
        super().__init__()
        self.dim, self.focal_level = dim, focal_level
        self.f = nn.Linear(dim, 2 * dim + focal_level + 1)
        self.focal_layers = nn.ModuleList([
            Conv3d(dim, dim, focal_factor * k + focal_window, bias=False,
                   groups=dim) for k in range(focal_level)])
        self.h = Conv3d(dim, dim, 1, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, levels = self.dim, self.focal_level
        q, ctx, gates = torch.split(linear(x, self.f), [c, c, levels + 1],
                                    dim=-1)
        ctx_all = torch.zeros_like(ctx)
        for k, conv in enumerate(self.focal_layers):
            ctx = F.gelu(conv(ctx))
            ctx_all = ctx_all + ctx * gates[..., k:k + 1]
        # the mean accumulates in fp32 and rounds once (jnp.mean's upcast)
        ctx_global = F.gelu(ctx.float().mean(dim=(1, 2, 3), keepdim=True)
                            .to(ctx.dtype))
        ctx_all = ctx_all + ctx_global * gates[..., levels:]
        return linear(q * self.h(ctx_all), self.proj)


class FocalModulationBlock(nn.Module):
    """LN -> focal modulation -> [gamma_1 *] DropPath -> + shortcut; LN ->
    MLP -> [gamma_2 *] DropPath -> + x. ``use_layerscale`` adds the fp32
    per-channel scales ``gamma_1`` / ``gamma_2``; as in JAX they promote the
    residual stream to fp32, and the block then keeps the MLP plain."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, focal_level: int = 2,
                 focal_window: int = 9, use_layerscale: bool = False,
                 layerscale_value: float = 1e-4):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.modulation = FocalModulation(dim, focal_level, focal_window)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path_rate)
        self.use_layerscale = use_layerscale
        if use_layerscale:
            self.gamma_1 = nn.Parameter(torch.full((dim,), layerscale_value))
            self.gamma_2 = nn.Parameter(torch.full((dim,), layerscale_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        g1 = self.gamma_1 if self.use_layerscale else 1.0
        g2 = self.gamma_2 if self.use_layerscale else 1.0
        xn = self.modulation(self.norm1(x))
        x = x + self.drop_path(g1 * xn)
        # the JAX gate: inference with the residual stream in the compute
        # dtype (layer-scale in bf16 / fp16 promotes it to fp32)
        if not self.training and x.dtype == xn.dtype:
            tokens = x.reshape(-1, c)
            ln = self.norm2.params()
            if not self.use_layerscale:
                return self.mlp(tokens, ln, residual=True).reshape(x.shape)
            return x + g2 * self.mlp(tokens, ln, residual=False).reshape(
                x.shape)
        return x + self.drop_path(g2 * self.mlp.plain(self.norm2(x)))


class FocalNet3D(nn.Module):
    """``PatchEmbed3D`` stem at ``patch_size``, then per stage ``depths[i]``
    focal modulation blocks, a stride-2 ``PatchEmbed3D`` with its norm
    (after every stage, the last included) and ``norm{i}`` on its output:
    the 5-scale pyramid [stem, norm0, .., norm3] of the UNETR decoder.
    forward(vol, crop_loc, affine) reads the volume only. The JAX module's
    dropout rates (0 in every configuration its factory builds) are left
    out, and its ``patch_norm`` (on in all of them) is always on."""

    def __init__(self, patch_size: Tuple3 = (2, 2, 2), in_chans: int = 1,
                 embed_dim: int = 48, depths: Sequence[int] = (2, 2, 2, 2),
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.2,
                 focal_levels: Sequence[int] = (2, 2, 2, 2),
                 focal_windows: Sequence[int] = (9, 9, 9, 9),
                 use_layerscale: bool = False):
        super().__init__()
        self.patch_embed = PatchEmbed3D(patch_size, in_chans, embed_dim)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList()
        for i, depth in enumerate(depths):
            dim = int(embed_dim * 2 ** i)
            stage = nn.Module()
            stage.blocks = nn.ModuleList([FocalModulationBlock(
                dim, mlp_ratio, dpr[sum(depths[:i]) + j],
                focal_levels[i], focal_windows[i], use_layerscale)
                for j in range(depth)])
            stage.downsample = PatchEmbed3D((2, 2, 2), dim, 2 * dim)
            self.layers.append(stage)
            setattr(self, f"norm{i}", LayerNorm(2 * dim))

    def forward(self, vol: torch.Tensor, crop_loc=None,
                affine=None) -> List[torch.Tensor]:
        x = self.patch_embed(vol)
        outputs = [x]
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x)
            x = stage.downsample(x)
            outputs.append(getattr(self, f"norm{i}")(x))
        return outputs
