"""Video-Swin's 3D backbone under the UNETR decoder (counterpart of
medicalsemseg_tpu/models/video_swin.py).

Its blocks are MONAI's official Swin blocks (``models/swin_official.py``:
per-axis window clamp with zeroed shifts, the constructor window's index
sliced ``[:n, :n]``, the region-id mask), which run kernel K1 and K2 in
``eval()`` mode and plain PyTorch in training, as the JAX blocks run
Pallas and XLA. What is Video-Swin's own: :class:`VideoPatchMerging` (all
eight octants, in its order), merging after every stage, the optional LN
after the patch embedding and the optional learned absolute position
table, and the raw 5-scale pyramid (no per-stage norm). Parameter names
follow the reference state_dict (``patch_embed.proj``, ``patch_embed.norm``,
``absolute_pos_embed``, ``layers.{k}.blocks.{i}``, ``layers.{k}.downsample``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from medicalsemseg_tpu_torch.models.layers import LayerNorm, linear
from medicalsemseg_tpu_torch.models.swin_official import (
    ConvPatchEmbed,
    OfficialStage,
    _octants,
)

Tuple3 = Tuple[int, int, int]


class VideoPatchMerging(nn.Module):
    """Video-Swin patch merging: all eight octants in Video-Swin's order
    -> LN(8C) -> dense to 2C without bias; the grid must be even."""

    ORDER = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1), (0, 0, 1),
             (0, 1, 1), (1, 0, 1), (0, 1, 0))

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(8 * dim)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(x.shape[1:4])
        if any(v % 2 for v in dims):
            raise ValueError(f"VideoPatchMerging needs even dims, got {dims}")
        return linear(self.norm(_octants(x, self.ORDER)), self.reduction)


class VideoSwin3D(nn.Module):
    """Video-Swin's SwinTransformer3D on the official blocks: the patch
    embedding (LN under ``patch_norm``), a learned absolute position table
    over the patch grid under ``ape`` (``--abs_pos_emb``), four stages each
    ending in :class:`VideoPatchMerging`; returns the raw pyramid [embed,
    s1 .. s4] (no per-stage norm) for the UNETR decoder. The blocks run the
    kernels in eval mode. ``img_size`` (the roi) sizes the position
    table."""

    def __init__(self, img_size: Tuple3, in_chans: int = 1,
                 embed_dim: int = 48, depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window: Tuple3 = (6, 6, 6), patch_size: Tuple3 = (2, 2, 2),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.1, patch_norm: bool = True,
                 ape: bool = False):
        super().__init__()
        self.patch_embed = ConvPatchEmbed(in_chans, embed_dim, patch_size,
                                          norm=patch_norm)
        if ape:
            grid = tuple(s // p for s, p in zip(img_size, patch_size))
            self.absolute_pos_embed = nn.Parameter(
                torch.zeros(1, *grid, embed_dim))
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList([OfficialStage(
            embed_dim * 2 ** k, depth, num_heads[k], tuple(window), mlp_ratio,
            qkv_bias, dpr[sum(depths[:k]):sum(depths[:k + 1])], True,
            VideoPatchMerging) for k, depth in enumerate(depths)])

    def forward(self, vol: torch.Tensor,
                crop_loc: Optional[torch.Tensor] = None,
                affine: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        x = self.patch_embed(vol)
        if hasattr(self, "absolute_pos_embed"):
            x = x + self.absolute_pos_embed.to(x.dtype)
        outs = [x]
        for stage in self.layers:
            x = stage(x)
            outs.append(x)
        return outs
