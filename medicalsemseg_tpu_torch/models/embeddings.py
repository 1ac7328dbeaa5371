"""Patch embedding (counterpart of medicalsemseg_tpu/models/embeddings.py)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from medicalsemseg_tpu_torch.models.layers import Conv3d, LayerNorm


class PatchEmbed3D(nn.Module):
    """(B, D, H, W, Cin) -> (B, D/p, H/p, W/p, C): a k = s = p conv, then
    LayerNorm. Trailing edges are zero-padded up to a multiple of p."""

    def __init__(self, patch_size: Tuple[int, int, int], in_chans: int,
                 embed_dim: int):
        super().__init__()
        if len(set(patch_size)) != 1:
            raise NotImplementedError(
                "anisotropic patches are not ported yet (ROADMAP queue 1 "
                "item 13, the rest of the model zoo)")
        self.patch = int(patch_size[0])
        self.proj = Conv3d(in_chans, embed_dim, self.patch, stride=self.patch,
                           padding=0)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        pads = [(-x.shape[i]) % p for i in (1, 2, 3)]
        if any(pads):
            x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        return self.norm(self.proj(x))
