"""3D shifted-window transformer encoder (counterpart of
medicalsemseg_tpu/models/swin.py: WindowAttention, SwinBlock, PatchMerging,
BasicLayer, SwinEncoder3D with the dense token MLP).

Every block runs the hand-written kernels: window attention (K1, backward
K3) and the token MLP (K2, backward K4). ``model.eval()`` gives the JAX
block's inference form (shortcuts inside the kernels), ``model.train()`` its
training form (shortcuts outside the kernels when DropPath is live). Module
and parameter names follow the reference
state_dict keys that ``medicalsemseg_tpu/utils/torch_import.py`` reads
(``layers.{i}.blocks.{j}.attn.qkv`` and so on).
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
)
from medicalsemseg_tpu_torch.ops.kernels.window_attention import (
    WindowAttentionFn,
    window_attention,
)
from medicalsemseg_tpu_torch.ops.window import (
    pad_to_multiple,
    relative_position_index,
    resolve_window,
    roll3,
    window_partition,
    window_reverse,
)

Tuple3 = Tuple[int, int, int]


class WindowAttention(nn.Module):
    """W-MSA / SW-MSA over cubic windows with a relative-position bias."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = False):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 3, num_heads))
        idx = relative_position_index((window_size,) * 3).astype(np.int64)
        self.register_buffer("rel_index", torch.from_numpy(idx).reshape(-1),
                             persistent=False)

    def gathered_bias(self) -> torch.Tensor:
        """(nh, N, N) fp32 bias gathered from the table."""
        n = self.window_size ** 3
        bias = self.relative_position_bias_table.float()[self.rel_index]
        return bias.reshape(n, n, self.num_heads).permute(2, 0, 1).contiguous()

    def forward(self, wins: torch.Tensor, grid_dims: Tuple3, shift: int,
                ln=None, residual: bool = False) -> torch.Tensor:
        dt = wins.dtype
        ws = self.window_size
        if torch.is_grad_enabled():
            return WindowAttentionFn.apply(
                wins.contiguous(), ln, self.qkv.weight, self.qkv.bias,
                self.proj.weight, self.proj.bias,
                self.relative_position_bias_table, self.rel_index, grid_dims,
                (ws,) * 3, (shift,) * 3, 1e-5, residual)
        return window_attention(
            wins, self.qkv.weight.to(dt),
            None if self.qkv.bias is None else self.qkv.bias.float(),
            self.proj.weight.to(dt), self.proj.bias.float(),
            self.gathered_bias(), grid_dims=grid_dims, window=(ws,) * 3,
            shift=(shift,) * 3, ln=ln, residual=residual)


class SwinBlock(nn.Module):
    """One W-MSA/SW-MSA block plus token MLP over (B, D, H, W, C), in the
    forms of the JAX SwinBlock with the fused kernels.

    When the grid is a multiple of the window (every flagship stage at roi
    96) the block takes the absorbed form: the kernel applies LN1 to the raw
    rolled volume. It also adds the shortcut itself, except in training with
    a live DropPath (``drop_path_rate > 0``): then the shortcut is added
    outside, around the dropped branch. Otherwise LN1 runs outside, the
    volume is zero-padded, and the shortcut is added after the crop (padding
    raw tokens would LN them to the LN bias, not to 0). The MLP always
    absorbs LN2, with its shortcut inside or outside by the same rule."""

    def __init__(self, dim: int, input_resolution: Tuple3, num_heads: int,
                 window_size: int, shift_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_path_rate: float = 0.0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        ws, _ = resolve_window(input_resolution, window_size, shift_size)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, ws, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        ws, ss = resolve_window((d, h, w), self.window_size, self.shift_size)
        if ws != self.attn.window_size:
            raise ValueError(
                f"grid {(d, h, w)} resolves to window {ws}, but the block was "
                f"built for window {self.attn.window_size}")
        dp, hp, wp = (v + (-v) % ws for v in (d, h, w))
        grid_dims = (dp // ws, hp // ws, wp // ws)
        res_in = not (self.training and self.drop_path.rate > 0.0)
        if (dp, hp, wp) == (d, h, w):
            xr = roll3(x, -ss)
            out = self.attn(window_partition(xr, ws), grid_dims, ss,
                            ln=self.norm1.params(), residual=res_in)
            out = roll3(window_reverse(out, ws, (d, h, w)), ss)
            x = out if res_in else x + self.drop_path(out)
        else:
            xn = roll3(pad_to_multiple(self.norm1(x), (ws,) * 3), -ss)
            out = self.attn(window_partition(xn, ws), grid_dims, ss)
            xn = roll3(window_reverse(out, ws, (dp, hp, wp)), ss)
            x = x + self.drop_path(xn[:, :d, :h, :w, :])
        y = self.mlp(x.reshape(-1, c), self.norm2.params(), residual=res_in)
        y = y.reshape(b, d, h, w, c)
        return y if res_in else x + self.drop_path(y)


class PatchMerging(nn.Module):
    """Exact GELU -> LN -> 3^3 stride-2 conv (pad 1) doubling channels."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.reduction = Conv3d(dim, 2 * dim, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduction(self.norm(F.gelu(x)))


class BasicLayer(nn.Module):
    """A stage: ``depth`` alternating W-MSA / SW-MSA blocks, then merging."""

    def __init__(self, dim: int, input_resolution: Tuple3, depth: int,
                 num_heads: int, window_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False,
                 drop_path_rates: Sequence[float] = (0.0,)):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, input_resolution, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                      qkv_bias, drop_path_rates[i])
            for i in range(depth)])
        self.downsample = PatchMerging(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The downsampled stage output (the encoder's next input)."""
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class SwinEncoder3D(nn.Module):
    """nnFormer-style hierarchical encoder. Returns the 5-scale pyramid
    [stem, s1, s2, s3, s4], where s_i is the LayerNorm of the *downsampled*
    output of stage i.

    ``img_size`` is the input's spatial size (the sliding-window roi): the
    per-stage window clamp, and with it the shape of each bias table, depends
    on the stage grids, as in the JAX model at init."""

    def __init__(self, img_size: Tuple3, patch_size: Tuple3 = (2, 2, 2),
                 in_chans: int = 1, embed_dim: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_sizes: Sequence[int] = (6, 6, 6, 6),
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.patch_embed = PatchEmbed3D(patch_size, in_chans, embed_dim)
        grid = tuple(-(-s // p) for s, p in zip(img_size, patch_size))
        # stochastic depth grows linearly over all blocks of the encoder
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList()
        for i in range(len(depths)):
            self.layers.append(BasicLayer(
                embed_dim * 2 ** i, grid, depths[i], num_heads[i],
                window_sizes[i], mlp_ratio, qkv_bias,
                dpr[sum(depths[:i]):sum(depths[:i + 1])]))
            self.add_module(f"norm{i}", LayerNorm(embed_dim * 2 ** (i + 1)))
            grid = tuple(-(-g // 2) for g in grid)

    def forward(self, vol: torch.Tensor) -> List[torch.Tensor]:
        x = self.patch_embed(vol)
        outputs = [x]
        for i, layer in enumerate(self.layers):
            x = layer(x)
            outputs.append(getattr(self, f"norm{i}")(x))
        return outputs
