"""The official nnFormer (counterpart of medicalsemseg_tpu/models/nnformer.py):
a symmetric Swin encoder-decoder with cross-attention skip fusion and
deep-supervision heads.

* Encoder: the conv stem (:class:`ProjectStem`), then the Swin stages of
  ``models/swin.py`` (``BasicLayer``: K1 / K3 and K2 / K4 in every block),
  each stage's output before merging normed into a skip; the deepest skip
  is the neck, so the last stage's merging is never computed (its
  parameters stay, and the train step gives them a zero gradient).
* Decoder: :class:`PatchExpanding` (LN + a kernel = stride 2 transposed
  conv halving the channels), ``x = up + skip``, then a stage whose first
  block is :class:`CrossSwinBlock` (queries from the upsampled path, keys
  and values from the skip; no shift, no mask) and whose other blocks are
  shifted Swin blocks.
* Heads: a kernel = stride = patch transposed conv per decoder scale. In
  training with ``deep_supervision`` the model returns [full, 1/2, 1/4];
  otherwise the full-resolution head alone.

``ref_quirk_index`` (``--ref_quirk_rel_pos``) gathers every relative-position
bias, the encoder's, the decoder's and the cross blocks', with the
reference's colliding-stride index. The cross attention has no JAX kernel
and is plain PyTorch; its MLP runs K2 (K4 in training). Parameter names
follow the JAX module names (``patch_embed.proj1_conv1``, ``layers.{i}``,
``norm{i}``, ``up.{j}``, ``decoder.{j}.cross``, ``decoder.{j}.blocks.{b}``,
``final.{j}``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medicalsemseg_tpu_torch.models.layers import (
    Conv3d,
    ConvTranspose3d,
    LayerNorm,
    Mlp,
    linear,
)
from medicalsemseg_tpu_torch.models.swin import BasicLayer, SwinBlock
from medicalsemseg_tpu_torch.ops.window import (
    gather_rel_bias,
    pad_to_multiple,
    relative_position_index,
    relative_position_index_ref_quirk,
    resolve_window,
    window_partition,
    window_reverse,
)

Tuple3 = Tuple[int, int, int]


def _same_pad(x: torch.Tensor, stride: Tuple3) -> torch.Tensor:
    """Zero-pad (B, D, H, W, C) as a 3^3 conv of ``stride`` with "SAME"
    padding does (lax's rule: the odd voxel of padding goes last)."""
    pads = []
    for n, s in zip(x.shape[1:4], stride):
        total = max((-(-n // s) - 1) * s + 3 - n, 0)
        pads.append((total // 2, total - total // 2))
    # F.pad pads from the last dim backwards: (C, W, H, D)
    return F.pad(x, (0, 0) + pads[2] + pads[1] + pads[0])


class _SameConv3d(Conv3d):
    """A 3^3 conv with "SAME" padding at any stride: at stride 1 the
    ``Conv3d`` 3^3 form (its kernel gates), strided through an explicit
    :func:`_same_pad` and no padding of its own."""

    def __init__(self, in_ch: int, out_ch: int, stride: Tuple3):
        strided = any(s != 1 for s in stride)
        super().__init__(in_ch, out_ch, 3, stride=tuple(stride) if strided
                         else 1, padding=0 if strided else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride != 1:
            x = _same_pad(x, self.stride)
        return super().forward(x)


class ProjectStem(nn.Module):
    """Two conv -> exact GELU -> LN stages of total stride ``patch``: 3^3
    convs to C / 2 at stride max(p // 2, 1) and stride 1, then to C at the
    rest of the patch and stride 1, the last followed by LN alone."""

    def __init__(self, in_chans: int, embed_dim: int,
                 patch_size: Tuple3 = (2, 2, 2)):
        super().__init__()
        s1 = tuple(max(p // 2, 1) for p in patch_size)
        s2 = tuple(p // s for p, s in zip(patch_size, s1))
        half = embed_dim // 2
        self.proj1_conv1 = _SameConv3d(in_chans, half, s1)
        self.proj1_norm = LayerNorm(half)
        self.proj1_conv2 = _SameConv3d(half, half, (1, 1, 1))
        self.proj1_norm2 = LayerNorm(half)
        self.proj2_conv1 = _SameConv3d(half, embed_dim, s2)
        self.proj2_norm = LayerNorm(embed_dim)
        self.proj2_conv2 = _SameConv3d(embed_dim, embed_dim, (1, 1, 1))
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj1_norm(F.gelu(self.proj1_conv1(x)))
        x = self.proj1_norm2(F.gelu(self.proj1_conv2(x)))
        x = self.proj2_norm(F.gelu(self.proj2_conv1(x)))
        return self.norm(self.proj2_conv2(x))


class CrossWindowAttention(nn.Module):
    """Window attention with the queries the *unprojected* LN'd upsampled
    tokens and K, V projected from the LN'd skip (``kv``: C -> 2C), plus
    the relative-position bias; no shift and no mask. Plain PyTorch in the
    JAX module's arithmetic (``q * scale`` in the compute dtype, fp32
    logits + bias, fp32 softmax rounded to the compute dtype, P.V and the
    projection in it)."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, ref_quirk_index: bool = False):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 3, num_heads))
        index_fn = (relative_position_index_ref_quirk if ref_quirk_index
                    else relative_position_index)
        idx = index_fn((window_size,) * 3).astype(np.int64)
        self.register_buffer("rel_index", torch.from_numpy(idx).reshape(-1),
                             persistent=False)

    def forward(self, skip_win: torch.Tensor,
                up_win: torch.Tensor) -> torch.Tensor:
        """Windows (T, N, C) of the skip and of the upsampled path ->
        (T, N, C)."""
        dt = skip_win.dtype
        t, n, c = skip_win.shape
        nh = self.num_heads
        hd = c // nh
        kv = linear(skip_win, self.kv).reshape(t, n, 2, nh, hd)
        k, v = kv.permute(2, 0, 3, 1, 4).unbind(0)
        q = up_win.to(dt).reshape(t, n, nh, hd).permute(0, 2, 1, 3)
        attn = torch.matmul((q * hd ** -0.5).float(),
                            k.float().transpose(-1, -2))
        bias = gather_rel_bias(self.relative_position_bias_table,
                               self.rel_index, n)
        p = torch.softmax(attn + bias[None], dim=-1).to(dt)
        out = torch.matmul(p, v).permute(0, 2, 1, 3).reshape(t, n, c)
        return linear(out, self.proj)


class CrossSwinBlock(nn.Module):
    """The first block of a decoder stage over (B, D, H, W, C): ``x`` (the
    sum of the upsampled path ``up`` and the ``skip``) plus the cross
    attention of LN1(skip) and LN1(up) (one LayerNorm for both, zero-padded
    to the window), then ``x + mlp(LN2(x))`` through the dense MLP's kernel
    (K2; K4 in training). Drop path 0, as in the JAX block."""

    def __init__(self, dim: int, input_resolution: Tuple3, num_heads: int,
                 window_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, ref_quirk_index: bool = False):
        super().__init__()
        ws, _ = resolve_window(input_resolution, window_size, 0)
        self.window_size = window_size
        self.norm1 = LayerNorm(dim)
        self.attn = CrossWindowAttention(dim, ws, num_heads, qkv_bias,
                                         ref_quirk_index)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                up: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        ws, _ = resolve_window((d, h, w), self.window_size, 0)
        if ws != self.attn.window_size:
            raise ValueError(
                f"grid {(d, h, w)} resolves to window {ws}, but the block was "
                f"built for window {self.attn.window_size}")
        skip_n = pad_to_multiple(self.norm1(skip), (ws,) * 3)
        up_n = pad_to_multiple(self.norm1(up), (ws,) * 3)
        out = self.attn(window_partition(skip_n, ws),
                        window_partition(up_n, ws))
        out = window_reverse(out, ws, tuple(skip_n.shape[1:4]))
        x = x + out[:, :d, :h, :w, :]
        return self.mlp(x.reshape(-1, c), self.norm2.params(),
                        residual=True).reshape(b, d, h, w, c)


class PatchExpanding(nn.Module):
    """LN, then a kernel = stride 2 transposed conv (with bias) halving the
    channels."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.up = ConvTranspose3d(dim, dim // 2, 2, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(self.norm(x))


class DecoderStage(nn.Module):
    """A decoder stage: the cross block, then ``depth - 1`` shifted Swin
    blocks (every one shifted by window // 2, as the JAX model builds
    them)."""

    def __init__(self, dim: int, grid: Tuple3, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float, qkv_bias: bool,
                 ref_quirk_index: bool):
        super().__init__()
        self.cross = CrossSwinBlock(dim, grid, num_heads, window_size,
                                    mlp_ratio, qkv_bias, ref_quirk_index)
        self.blocks = nn.ModuleList([
            SwinBlock(dim, grid, num_heads, window_size, window_size // 2,
                      mlp_ratio, qkv_bias, ref_quirk_index=ref_quirk_index)
            for _ in range(1, depth)])

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                up: torch.Tensor) -> torch.Tensor:
        x = self.cross(x, skip, up)
        for blk in self.blocks:
            x, _ = blk(x)
        return x


class NNFormer(nn.Module):
    """The whole model. forward((vol (B, D, H, W, Cin), crop_loc, affine))
    -> (B, D, H, W, n_classes) fp32 logits; in training with
    ``deep_supervision`` the list [full, 1/2, 1/4] of the heads' logits.

    ``img_size`` is the input's spatial size (the sliding-window roi): the
    window clamp of each stage, and with it the shape of each bias table,
    depends on the stage grids, as in the JAX model at init."""

    def __init__(self, img_size: Tuple3, out_channels: int,
                 in_chans: int = 1, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_sizes: Sequence[int] = (4, 4, 4, 4),
                 patch_size: Tuple3 = (2, 2, 2), mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.2,
                 deep_supervision: bool = False,
                 ref_quirk_index: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.deep_supervision = deep_supervision
        nl = len(depths)
        self.patch_embed = ProjectStem(in_chans, embed_dim, patch_size)
        grid = tuple(-(-s // p) for s, p in zip(img_size, patch_size))
        grids = []
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList()
        for i in range(nl):
            dim = embed_dim * 2 ** i
            grids.append(grid)
            self.layers.append(BasicLayer(
                dim, grid, depths[i], num_heads[i], window_sizes[i],
                mlp_ratio, qkv_bias, dpr[sum(depths[:i]):sum(depths[:i + 1])],
                ref_quirk_index=ref_quirk_index))
            self.add_module(f"norm{i}", LayerNorm(dim))
            grid = tuple(-(-g // 2) for g in grid)
        heads, windows = num_heads[::-1][1:], window_sizes[::-1][1:]
        self.up = nn.ModuleList()
        self.decoder = nn.ModuleList()
        for j in range(nl - 1):
            dim_in = embed_dim * 2 ** (nl - 1 - j)
            self.up.append(PatchExpanding(dim_in))
            self.decoder.append(DecoderStage(
                dim_in // 2, grids[nl - 2 - j], depths[::-1][1:][j],
                heads[j], windows[j], mlp_ratio, qkv_bias, ref_quirk_index))
        self.final = nn.ModuleList([
            ConvTranspose3d(embed_dim * 2 ** j, out_channels,
                            tuple(patch_size), bias=True)
            for j in range(nl - 1)])

    def forward(self, x_in: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        x = self.patch_embed(x_in[0].to(self.dtype))
        nl = len(self.layers)
        skips = []
        for i, layer in enumerate(self.layers):
            x_out, x, _ = layer(x, downsample=i < nl - 1)
            skips.append(getattr(self, f"norm{i}")(x_out))
        x = skips[-1]
        outs = []
        for j, (up_j, stage) in enumerate(zip(self.up, self.decoder)):
            up = up_j(x)
            skip = skips[nl - 2 - j]
            x = stage(up + skip, skip, up)
            outs.append(x)
        if self.deep_supervision and self.training:
            return [head(feat).float()
                    for head, feat in zip(self.final, reversed(outs))]
        return self.final[0](outs[-1]).float()
