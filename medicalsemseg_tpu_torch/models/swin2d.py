"""2D shifted-window transformer, the ``--input_dim 2`` model (counterpart
of medicalsemseg_tpu/models/swin2d.py): the vanilla Swin pyramid over
(B, H, W, C) images and ``Swin2DSeg``, a linear-fuse segmentation head on it.

Everything is plain PyTorch, as the JAX package runs XLA here: attention
with fp32 logits plus the relative-position bias and the shifted-window mask
(-100 between regions), fp32 softmax rounded to the compute dtype. A block
whose resolution is no larger than the window clamps the window to the
resolution and does not shift, as the reference does. Module names follow
the Swin layout (``layers.{i}.blocks.{j}.attn.qkv``,
``layers.{i}.downsample.reduction``, ``patch_embed.proj``), the head the
JAX scopes (``linear_c{i}``, ``linear_fuse``, ``fuse_norm``,
``linear_pred``). The CLIs feed 3D volumes only, so the model is built and
trained through :func:`models.factory.build_model` alone, as in JAX.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medicalsemseg_tpu_torch.models.layers import (
    DropPath,
    LayerNorm,
    Mlp,
    linear,
)
from medicalsemseg_tpu_torch.ops.resize import resize_linear

Tuple2 = Tuple[int, int]


@functools.lru_cache(maxsize=None)
def relative_position_index_2d(ws: Tuple2) -> np.ndarray:
    """(Wh * Ww, Wh * Ww) index into the (2 Wh - 1)(2 Ww - 1) bias table."""
    wh, ww = ws
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def window_partition_2d(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws * ws, C), batch-major window order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse_2d(wins: torch.Tensor, ws: int, hw: Tuple2) -> torch.Tensor:
    """(B * nW, ws * ws, C) -> (B, H, W, C)."""
    h, w = hw
    c = wins.shape[-1]
    x = wins.reshape(-1, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


@functools.lru_cache(maxsize=None)
def shift_attn_mask_2d(res: Tuple2, ws: int, ss: int) -> np.ndarray:
    """(nW, N, N) fp32 mask of the shifted windows: 0 within a region, -100
    between regions, the regions those of the reference's image slices."""
    h, w = res
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
        for wsl in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention2D(nn.Module):
    """W-MSA over (B * nW, N, C) windows with a relative-position bias."""

    def __init__(self, dim: int, window_size: Tuple2, num_heads: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        wh, ww = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wh - 1) * (2 * ww - 1), num_heads))
        idx = relative_position_index_2d(tuple(window_size)).reshape(-1)
        self.register_buffer("rel_index", torch.from_numpy(idx),
                             persistent=False)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        t, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = linear(x, self.qkv).reshape(t, n, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = torch.matmul((q * hd ** -0.5).float(),
                            k.float().transpose(-1, -2))
        bias = self.relative_position_bias_table.float()[self.rel_index]
        attn = attn + bias.reshape(n, n, nh).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(t // nw, nw, nh, n, n)
                    + mask[None, :, None]).reshape(t, nh, n, n)
        p = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(p, v).permute(0, 2, 1, 3).reshape(t, n, c)
        return linear(out, self.proj)


class SwinBlock2D(nn.Module):
    """One W-MSA / SW-MSA block over a (B, H, W, C) map of the given
    resolution; where min(resolution) <= window, the window becomes
    min(resolution) and the shift 0."""

    def __init__(self, dim: int, input_resolution: Tuple2, num_heads: int,
                 window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        ws, ss = window_size, shift_size
        if min(self.input_resolution) <= ws:
            ss, ws = 0, min(self.input_resolution)
        if any(r % ws for r in self.input_resolution):
            raise ValueError(f"Swin2D: a stage's grid {self.input_resolution} "
                             f"is no multiple of the window {ws}")
        self.window_size, self.shift_size = ws, ss
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention2D(dim, (ws, ws), num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path_rate)
        mask = (torch.from_numpy(shift_attn_mask_2d(self.input_resolution, ws,
                                                    ss)) if ss else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        if (h, w) != self.input_resolution:
            raise ValueError(f"SwinBlock2D built for {self.input_resolution}, "
                             f"given {(h, w)}")
        ws, ss = self.window_size, self.shift_size
        xn = self.norm1(x)
        if ss:
            xn = torch.roll(xn, shifts=(-ss, -ss), dims=(1, 2))
        wins = self.attn(window_partition_2d(xn, ws), self.attn_mask)
        xn = window_reverse_2d(wins, ws, (h, w))
        if ss:
            xn = torch.roll(xn, shifts=(ss, ss), dims=(1, 2))
        x = x + self.drop_path(xn)
        return x + self.drop_path(self.mlp.plain(self.norm2(x)))


class PatchMerging2D(nn.Module):
    """2 x 2 neighbourhoods concatenated in the order (0, 0), (1, 0), (0, 1),
    (1, 1) -> LN(4C) -> dense to 2C without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return linear(self.norm(x), self.reduction)


class PatchEmbed2D(nn.Module):
    """Non-overlapping p x p patches of (B, H, W, Cin) -> (B, H/p, W/p, C),
    the VALID conv ``proj`` (torch's Conv2d layout) run as one dense layer
    over each patch, then LayerNorm."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        b, h, w, c = x.shape
        gh, gw = h // p, w // p
        x = x[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh, gw, p * p * c)
        wt = self.proj.weight.permute(0, 2, 3, 1).reshape(
            self.proj.weight.shape[0], -1)
        return self.norm(F.linear(x, wt.to(x.dtype),
                                  self.proj.bias.to(x.dtype)))


class SwinTransformer2D(nn.Module):
    """The 2D Swin classifier: forward((B, H, W, Cin) images, H = W =
    ``img_size``) -> class logits (B, num_classes) through the final LN, the
    mean over tokens and ``head``; with ``features_only`` (which builds no
    ``norm`` or ``head``) the per-stage pyramid [(B, H/p, W/p, C), ..., (B,
    H/(8p), W/(8p), 8C)] of the blocks' outputs before merging. Computes in
    ``dtype``. The JAX module's dropout rates (0 in the factory's model)
    are left out, and its ``patch_norm`` (on there) is always on."""

    def __init__(self, img_size: int = 224, patch_size: int = 4,
                 in_chans: int = 3, num_classes: int = 1000,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.1,
                 ape: bool = False, features_only: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.in_chans = img_size, in_chans
        self.features_only, self.dtype = features_only, dtype
        self.patch_embed = PatchEmbed2D(patch_size, in_chans, embed_dim)
        h0 = img_size // patch_size
        self.absolute_pos_embed = (nn.Parameter(torch.zeros(
            1, h0 * h0, embed_dim)) if ape else None)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList()
        for i, depth in enumerate(depths):
            dim, res = embed_dim * 2 ** i, (h0 // 2 ** i,) * 2
            stage = nn.Module()
            stage.blocks = nn.ModuleList([SwinBlock2D(
                dim, res, num_heads[i], window_size,
                0 if j % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias,
                dpr[sum(depths[:i]) + j]) for j in range(depth)])
            if i < len(depths) - 1:
                stage.downsample = PatchMerging2D(dim)
            self.layers.append(stage)
        if not features_only:
            last = embed_dim * 2 ** (len(depths) - 1)
            self.norm = LayerNorm(last)
            self.head = (nn.Linear(last, num_classes) if num_classes > 0
                         else None)

    def forward(self, x: torch.Tensor):
        if (x.shape[-1] != self.in_chans
                or x.shape[1] != self.img_size or x.shape[2] != self.img_size):
            raise ValueError(f"SwinTransformer2D takes (B, {self.img_size}, "
                             f"{self.img_size}, {self.in_chans}), given "
                             f"{tuple(x.shape)}")
        x = self.patch_embed(x.to(self.dtype))
        if self.absolute_pos_embed is not None:
            x = x + self.absolute_pos_embed.reshape(x.shape[1:]).to(x.dtype)
        feats: List[torch.Tensor] = []
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x)
            feats.append(x)
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
        if self.features_only:
            return feats
        x = self.norm(x).mean(dim=(1, 2))
        return x if self.head is None else linear(x, self.head)


class Swin2DSeg(nn.Module):
    """2D segmentation over the Swin pyramid: each scale densely to
    ``head_dim`` (``linear_c{i}``) and resized bilinearly to the finest
    scale, concatenated coarsest first, ``linear_fuse`` (no bias), LN,
    ReLU, ``linear_pred`` in fp32, bilinear resize to the image; the
    compute dtype is the backbone's ``dtype``. forward((image (B, H, W,
    Cin), crop_loc, affine)) -> (B, H, W, num_classes) fp32 logits."""

    def __init__(self, img_size: int, num_classes: int, in_chans: int = 1,
                 embed_dim: int = 48, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, patch_size: int = 4,
                 head_dim: int = 256, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = SwinTransformer2D(
            img_size, patch_size, in_chans, 0, embed_dim, depths, num_heads,
            window_size, mlp_ratio, qkv_bias, drop_path_rate,
            features_only=True, dtype=dtype)
        for i in range(len(depths)):
            setattr(self, f"linear_c{i}", nn.Linear(embed_dim * 2 ** i,
                                                     head_dim))
        self.linear_fuse = nn.Linear(len(depths) * head_dim, head_dim,
                                     bias=False)
        self.fuse_norm = LayerNorm(head_dim)
        self.linear_pred = nn.Linear(head_dim, num_classes)

    def forward(self, x_in) -> torch.Tensor:
        img = x_in[0] if isinstance(x_in, (tuple, list)) else x_in
        h, w = img.shape[1:3]
        feats = self.backbone(img)
        h4, w4 = feats[0].shape[1:3]
        fused = []
        for i, f in enumerate(feats):
            f = linear(f, getattr(self, f"linear_c{i}"))
            if f.shape[1:3] != (h4, w4):
                f = resize_linear(f, (h4, w4))
            fused.append(f)
        x = linear(torch.cat(fused[::-1], dim=-1), self.linear_fuse)
        x = F.relu(self.fuse_norm(x))
        pred = self.linear_pred
        x = F.linear(x.float(), pred.weight.float(), pred.bias.float())
        return resize_linear(x, (h, w))
