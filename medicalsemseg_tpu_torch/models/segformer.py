"""SegFormer3D encoder (counterpart of medicalsemseg_tpu/models/segformer.py:
DWConvMlp, SRAttention, MixBlock, OverlapPatchEmbed, MixVisionTransformer3D),
at inference and in training.

Four overlapping-patch-embed stages (7^3 stride 4, then 3^3 stride 2); each
block attends its N tokens against M = N / sr^3 spatially reduced keys and
values, then runs a depthwise-conv MLP. The N-token side of the attention (q
dense, per-head softmax, . V, proj and the block's shortcut) is kernel K7;
the M-token side (the spatial-reduction conv, its LayerNorm and the kv dense)
stays PyTorch, as the JAX package leaves it to XLA. K7 has no backward
kernel, in the JAX package either: in training the attention runs the
module's own unfused form, the counterpart of the JAX block's XLA branch,
with the shortcut outside around a DropPath (stochastic depth, rising
linearly over the blocks as in JAX); in eval mode it runs K7 and refuses to
run with gradients enabled.
Module names follow the JAX scopes (``patch_embed{s}``, ``block{s}_{i}``,
``norm{s}``, ``attn.{q,kv,proj,sr,norm}``, ``mlp.{fc1,dwconv,fc2}``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medicalsemseg_tpu_torch.models.layers import (
    Conv3d,
    DropPath,
    LayerNorm,
    linear,
)
from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr

Tuple3 = Tuple[int, int, int]

_EVAL_GRAD = ("SRAttention in eval mode runs kernel K7, which has no backward "
              "kernel: call the model under torch.inference_mode() or "
              "torch.no_grad(), or in train() mode for the differentiable "
              "unfused form")


class DWConvMlp(nn.Module):
    """fc1 -> depthwise 3^3 conv over the token grid -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = Conv3d(hidden, hidden, 3, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, grid: Tuple3) -> torch.Tensor:
        b, n, _ = x.shape
        h = linear(x, self.fc1)
        h = self.dwconv(h.reshape(b, *grid, -1)).reshape(b, n, -1)
        return linear(F.gelu(h), self.fc2)


class SRAttention(nn.Module):
    """Attention against spatially reduced keys and values. The kv dense's
    output columns are [2, heads, head dim]: the first C are K, the last C
    are V, head-major."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = False):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv3d(dim, dim, sr_ratio, stride=sr_ratio, padding=0)
            self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor, grid: Tuple3,
                shortcut: torch.Tensor = None) -> torch.Tensor:
        """LayerNorm'ed tokens x (B, N, C) -> [shortcut +] attention(x):
        kernel K7 in eval mode (without gradients), the unfused form in
        training, which leaves the shortcut to the caller."""
        if not self.training and torch.is_grad_enabled():
            raise NotImplementedError(_EVAL_GRAD)
        b, n, c = x.shape
        dt = x.dtype
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.norm(self.sr(x.reshape(b, *grid, c)).reshape(b, -1, c))
        kv = linear(kv_in, self.kv)
        if self.training:
            return self.unfused(x, kv)
        return ksr.sr_attention(
            x.contiguous(), kv[:, :, :c].contiguous(),
            kv[:, :, c:].contiguous(), self.q.weight.to(dt),
            None if self.q.bias is None else self.q.bias.float(),
            self.proj.weight.to(dt), self.proj.bias.float(), self.num_heads,
            residual=None if shortcut is None else shortcut.contiguous())

    def unfused(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """The attention as the JAX module's XLA branch computes it (q dense
        in the compute dtype, fp32 logits scaled after the dot, fp32 softmax
        rounded to the compute dtype, . V and proj in it), in PyTorch ops
        that autograd differentiates."""
        b, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        m = kv.shape[1]
        q = linear(x, self.q).reshape(b, n, nh, hd).permute(0, 2, 1, 3)
        k, v = kv.reshape(b, m, 2, nh, hd).permute(2, 0, 3, 1, 4).unbind(0)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
        out = torch.matmul(torch.softmax(attn, dim=-1).to(x.dtype), v)
        return linear(out.permute(0, 2, 1, 3).reshape(b, n, c), self.proj)


class MixBlock(nn.Module):
    """LN -> SR attention (+ shortcut, inside the kernel at inference) -> LN
    -> DWConv MLP (+ shortcut), with DropPath on both branches in training.
    LN1 stays outside the kernel: its output also feeds the
    spatial-reduction conv."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = SRAttention(dim, num_heads, sr_ratio, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = DWConvMlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, grid: Tuple3) -> torch.Tensor:
        if self.training:
            x = x + self.drop_path(self.attn(self.norm1(x), grid))
        else:
            x = self.attn(self.norm1(x), grid, shortcut=x)
        return x + self.drop_path(self.mlp(self.norm2(x), grid))


class OverlapPatchEmbed(nn.Module):
    """Strided overlapping conv (padding patch // 2) -> tokens -> LN."""

    def __init__(self, in_ch: int, embed_dim: int, patch_size: int,
                 stride: int):
        super().__init__()
        self.proj = Conv3d(in_ch, embed_dim, patch_size, stride=stride,
                           padding=patch_size // 2)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple3]:
        x = self.proj(x)
        grid = tuple(x.shape[1:4])
        return self.norm(x.reshape(x.shape[0], -1, x.shape[-1])), grid


class MixVisionTransformer3D(nn.Module):
    """The 4-stage encoder. Returns [stage-1 embedding as a volume, s1..s4]
    with channels embed_dim * 2^i at resolutions /4, /8, /16, /32; the head
    reads the last four."""

    def __init__(self, in_chans: int = 1, embed_dim: int = 48,
                 depths: Sequence[int] = (3, 4, 6, 3),
                 num_heads: Sequence[int] = (1, 2, 4, 8),
                 mlp_ratios: Sequence[float] = (4.0, 4.0, 4.0, 4.0),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 qkv_bias: bool = False, drop_path_rate: float = 0.0):
        super().__init__()
        self.depths = tuple(depths)
        dims = [embed_dim * 2 ** i for i in range(len(depths))]
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        for s in range(len(depths)):
            self.add_module(f"patch_embed{s + 1}", OverlapPatchEmbed(
                in_chans if s == 0 else dims[s - 1], dims[s],
                7 if s == 0 else 3, 4 if s == 0 else 2))
            for i in range(depths[s]):
                self.add_module(f"block{s + 1}_{i}", MixBlock(
                    dims[s], num_heads[s], sr_ratios[s], mlp_ratios[s],
                    qkv_bias, dpr[sum(depths[:s]) + i]))
            self.add_module(f"norm{s + 1}", LayerNorm(dims[s]))

    def forward(self, vol: torch.Tensor, crop_loc=None,
                affine=None) -> List[torch.Tensor]:
        """The pyramid of ``vol``; ``crop_loc`` and ``affine`` are not read
        (the encoders' common signature)."""
        x = vol
        outs = []
        for s, depth in enumerate(self.depths):
            tokens, grid = getattr(self, f"patch_embed{s + 1}")(x)
            if s == 0:
                outs.append(tokens.reshape(tokens.shape[0], *grid, -1))
            for i in range(depth):
                tokens = getattr(self, f"block{s + 1}_{i}")(tokens, grid)
            tokens = getattr(self, f"norm{s + 1}")(tokens)
            x = tokens.reshape(tokens.shape[0], *grid, -1)
            outs.append(x)
        return outs
