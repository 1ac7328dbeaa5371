"""3D Vision Transformer encoder (counterpart of
medicalsemseg_tpu/models/vit.py): the ViT of UNETR_Official, with the
ViT-MAE options (a class token, layer-scale ``init_values``).

Global self-attention over every token of a window is plain PyTorch, as
the JAX package leaves it to XLA: q scaled in the compute dtype, fp32
logits and softmax, the probabilities rounded to the compute dtype before
P.V. The MLP after LN2 runs kernel K2 with the LayerNorm absorbed in
``eval()`` mode (``residual=True``, or ``x + gamma_2 * mlp`` with
``init_values``; with gradients enabled K2 forward and K4 backward), and
plain PyTorch with DropPath in training, as the JAX block runs XLA there.
Module names follow the JAX scopes (``blocks.{i}.attn.qkv``, ``pos_embed``,
``norm``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from medicalsemseg_tpu_torch.models.embeddings import PatchEmbed3D
from medicalsemseg_tpu_torch.models.layers import (
    DropPath,
    LayerNorm,
    Mlp,
    linear,
)

Tuple3 = Tuple[int, int, int]


class SelfAttention(nn.Module):
    """Multi-head self-attention over (B, N, C) tokens."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = linear(x, self.qkv).reshape(b, n, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = torch.matmul((q * hd ** -0.5).float(),
                            k.float().transpose(-1, -2))
        p = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(p, v).permute(0, 2, 1, 3).reshape(b, n, c)
        return linear(out, self.proj)


class TransformerBlock(nn.Module):
    """Pre-norm block: x + [gamma_1 *] attn(LN1(x)), then the MLP after LN2
    (see the module docstring for its routes). ``init_values`` adds the
    fp32 layer-scale vectors ``gamma_1`` / ``gamma_2``; as in JAX they
    promote the residual stream to fp32, and the block then keeps the MLP
    plain."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0,
                 init_values: Optional[float] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = SelfAttention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path_rate)
        self.layer_scale = init_values is not None
        if self.layer_scale:
            self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
            self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g1 = self.gamma_1 if self.layer_scale else 1.0
        g2 = self.gamma_2 if self.layer_scale else 1.0
        h = self.attn(self.norm1(x))
        x = x + self.drop_path(g1 * h)
        if not self.training and x.dtype == h.dtype:
            tokens = x.reshape(-1, x.shape[-1])
            ln = self.norm2.params()
            if not self.layer_scale:
                return self.mlp(tokens, ln, residual=True).reshape(x.shape)
            return x + g2 * self.mlp(tokens, ln, residual=False).reshape(
                x.shape)
        return x + self.drop_path(g2 * self.mlp.plain(self.norm2(x)))


class ViT3D(nn.Module):
    """Plain 3D-patch transformer with intermediate-layer taps: forward(vol)
    returns the (B, gd, gh, gw, C) tokens after each 1-based block index of
    ``out_indices``, the last one replaced by the final LayerNorm's output.
    ``pos_embed`` (1, N, C) is tied to the volume ``img_size``. The JAX
    module's dropout rates (0 in every configuration its factory builds)
    are left out."""

    def __init__(self, img_size: Tuple3, patch_size: Tuple3 = (16, 16, 16),
                 in_chans: int = 1, hidden_size: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0,
                 out_indices: Sequence[int] = (3, 6, 9, 12),
                 use_cls_token: bool = False,
                 init_values: Optional[float] = None):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.grid = tuple(math.ceil(v / p) for v, p in zip(img_size,
                                                            patch_size))
        self.patch_embed = PatchEmbed3D(patch_size, in_chans, hidden_size,
                                        use_norm=False)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, int(np.prod(self.grid)), hidden_size))
        self.cls_token = (nn.Parameter(torch.zeros(1, 1, hidden_size))
                          if use_cls_token else None)
        dpr = np.linspace(0, drop_path_rate, depth).tolist()
        self.blocks = nn.ModuleList([TransformerBlock(
            hidden_size, num_heads, mlp_ratio, qkv_bias, dpr[i], init_values)
            for i in range(depth)])
        self.norm = LayerNorm(hidden_size)

    def forward(self, vol: torch.Tensor, crop_loc=None,
                affine=None) -> List[torch.Tensor]:
        x = self.patch_embed(vol)
        b, gd, gh, gw, c = x.shape
        if (gd, gh, gw) != self.grid:
            raise ValueError(f"ViT3D: a token grid of {(gd, gh, gw)}, but "
                             f"pos_embed is tied to {self.grid}")
        tokens = x.reshape(b, -1, c) + self.pos_embed.to(x.dtype)
        skip = 0
        if self.cls_token is not None:
            tokens = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, c),
                                tokens], dim=1)
            skip = 1
        taps = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i + 1 in self.out_indices:
                taps.append(tokens[:, skip:].reshape(b, gd, gh, gw, c))
        taps[-1] = self.norm(tokens)[:, skip:].reshape(b, gd, gh, gw, c)
        return taps
