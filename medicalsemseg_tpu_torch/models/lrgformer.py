"""LRGFormer: joint local / region / global token attention (counterpart of
medicalsemseg_tpu/models/lrgformer.py, itself a repair of the reference's
broken module; see its docstring).

Three token streams are attended jointly in every block, each with its own
QKV and output projection: local tokens (``PatchEmbed3D`` at the local
patch), region tokens (``PatchEmbedRegion``) and one global token
(``PatchEmbedGlobal``). The attention is plain PyTorch, as the JAX package
leaves it to XLA, with the queries in chunks of 2048 so that the (N, N)
logits never exist at once: fp32 logits and softmax, the probabilities
rounded to V's dtype before P.V. The MLP is plain too: no kernel serves
this model in either package. Between stages the local and region grids go
through the Swin ``PatchMerging`` (3^3 stride-2 conv, padding 1) and the
global token through a dense layer.

The JAX module keeps the grids of the next stage as max(g // 2, 1) while the
merging gives ceil(g / 2): where a grid axis that is merged before another
stage is odd and above 1 (at depths 2-2-2-2: ``--vol_size`` 96 and 160),
the JAX model fails in a reshape. The port raises a ``ValueError`` there
when it is built (:func:`lrg_stage_grids`) and runs where JAX runs (64, 128).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from medicalsemseg_tpu_torch.models.embeddings import (
    PatchEmbed3D,
    PatchEmbedGlobal,
    PatchEmbedRegion,
)
from medicalsemseg_tpu_torch.models.layers import (
    DropPath,
    LayerNorm,
    Mlp,
    linear,
)
from medicalsemseg_tpu_torch.models.swin import PatchMerging

Tuple3 = Tuple[int, int, int]

Q_CHUNK = 2048


def chunked_softmax_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              chunk: int = Q_CHUNK) -> torch.Tensor:
    """softmax(q k^T) v over (B, nh, N, hd), the queries in chunks of
    ``chunk`` rows (the last one shorter: the rows the JAX function pads
    and drops are never computed): the logits of one chunk, (B, nh, chunk,
    N) fp32, are the largest tensor."""
    kt = k.float().transpose(-1, -2)
    outs = []
    for s in range(0, q.shape[2], chunk):
        logits = torch.matmul(q[:, :, s:s + chunk].float(), kt)
        p = torch.softmax(logits, dim=-1).to(v.dtype)
        del logits
        outs.append(torch.matmul(p, v))
    return torch.cat(outs, dim=2)


def lrg_stage_grids(dims: Tuple3, patch: Tuple3, region_factor: int,
                    n_stages: int):
    """(region size, [(local grid, region grid) of each stage]) of a volume
    ``dims``; raises ``ValueError`` where the JAX module fails: a volume
    that is no multiple of patch * region_factor, or a merging whose grid
    (ceil(g / 2)) differs from the one the JAX bookkeeping keeps for the
    next stage (max(g // 2, 1))."""
    for d, p in zip(dims, patch):
        if d % (p * region_factor):
            raise ValueError(f"LRGFormer: the volume {tuple(dims)} must be a "
                             f"multiple of patch * region_factor = "
                             f"{p * region_factor} on every axis")
    region = tuple(d // (d // (p * region_factor))
                   for d, p in zip(dims, patch))
    grids = [(tuple(d // p for d, p in zip(dims, patch)),
              tuple(d // r for d, r in zip(dims, region)))]
    for i in range(n_stages - 1):
        nxt = []
        for name, g in zip(("local", "region"), grids[-1]):
            merged = tuple(-(-v // 2) for v in g)
            kept = tuple(max(v // 2, 1) for v in g)
            if merged != kept:
                raise ValueError(
                    f"LRGFormer at the volume {tuple(dims)}: the {name} token "
                    f"grid {g} of stage {i + 1} merges to {merged}, but the "
                    f"JAX module's grid bookkeeping keeps {kept} for stage "
                    f"{i + 2}, and the JAX model fails there (at depths "
                    f"2-2-2-2 --vol_size 96 and 160 fail, 64 and 128 run)")
            nxt.append(merged)
        grids.append(tuple(nxt))
    return region, grids


class LRGAttention(nn.Module):
    """Joint attention over [local | region | global] tokens with per-stream
    QKV (``qkv_local`` / ``_region`` / ``_global``) and output projections
    (``proj_*``)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        for s in ("local", "region", "global"):
            setattr(self, f"qkv_{s}", nn.Linear(dim, 3 * dim, bias=qkv_bias))
            setattr(self, f"proj_{s}", nn.Linear(dim, dim))

    def forward(self, xl: torch.Tensor, xr: torch.Tensor, xg: torch.Tensor):
        b, nl, c = xl.shape
        nr = xr.shape[1]
        nh = self.num_heads
        hd = c // nh

        def qkv_of(x, lin):
            return linear(x, lin).reshape(b, x.shape[1], 3, nh, hd).permute(
                2, 0, 3, 1, 4)

        streams = [qkv_of(xl, self.qkv_local), qkv_of(xr, self.qkv_region),
                   qkv_of(xg, self.qkv_global)]
        q, k, v = (torch.cat([s[i] for s in streams], dim=2)
                   for i in range(3))
        out = chunked_softmax_attention(q * hd ** -0.5, k, v)
        out = out.permute(0, 2, 1, 3).reshape(b, -1, c)
        return (linear(out[:, :nl], self.proj_local),
                linear(out[:, nl:nl + nr], self.proj_region),
                linear(out[:, nl + nr:], self.proj_global))


class LRGBlock(nn.Module):
    """x + DropPath(joint attention of LN1(x)), then x + DropPath(MLP of
    LN2(x)), over the concatenated [local | region | global] tokens."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = LRGAttention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, nl: int, nr: int) -> torch.Tensor:
        xn = self.norm1(x)
        y = torch.cat(self.attn(xn[:, :nl], xn[:, nl:nl + nr],
                                xn[:, nl + nr:]), dim=1)
        x = x + self.drop_path(y)
        return x + self.drop_path(self.mlp.plain(self.norm2(x)))


class LRGFormer3D(nn.Module):
    """The hierarchical LRG encoder: forward(vol, crop_loc, affine) -> the
    5-scale pyramid [local embedding, norm0, .., norm3] of the UNETR decoder.
    The volume ``img_size`` fixes the global embedding's kernel (a quarter
    of the volume) and is checked when the model is built. The JAX module's
    ``patch_norm`` (on in every configuration its factory builds) is always
    on."""

    def __init__(self, img_size: Tuple3, patch_size: Tuple3 = (4, 4, 4),
                 region_factor: int = 4, in_chans: int = 1,
                 embed_dim: int = 48, depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.2):
        super().__init__()
        self.img_size = tuple(img_size)
        region, _ = lrg_stage_grids(self.img_size, tuple(patch_size),
                                    region_factor, len(depths))
        self.patch_embed_local = PatchEmbed3D(patch_size, in_chans, embed_dim)
        self.patch_embed_region = PatchEmbedRegion(region, in_chans,
                                                   embed_dim)
        self.patch_embed_global = PatchEmbedGlobal(self.img_size, in_chans,
                                                   embed_dim)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList()
        for i, depth in enumerate(depths):
            dim = embed_dim * 2 ** i
            stage = nn.Module()
            stage.blocks = nn.ModuleList([LRGBlock(
                dim, num_heads[i], mlp_ratio, qkv_bias,
                dpr[sum(depths[:i]) + j]) for j in range(depth)])
            stage.downsample_local = PatchMerging(dim)
            stage.downsample_region = PatchMerging(dim)
            stage.downsample_global = nn.Linear(dim, 2 * dim)
            self.layers.append(stage)
            setattr(self, f"norm{i}", LayerNorm(2 * dim))

    def forward(self, vol: torch.Tensor, crop_loc=None,
                affine=None) -> List[torch.Tensor]:
        if tuple(vol.shape[1:4]) != self.img_size:
            raise ValueError(f"LRGFormer3D built for the volume "
                             f"{self.img_size}, given {tuple(vol.shape[1:4])}")
        xl = self.patch_embed_local(vol)
        xr = self.patch_embed_region(vol)
        xg = self.patch_embed_global(vol)
        b = vol.shape[0]
        outputs = [xl]
        for i, stage in enumerate(self.layers):
            lgrid, rgrid, dim = xl.shape[1:4], xr.shape[1:4], xl.shape[-1]
            nl, nr = int(np.prod(lgrid)), int(np.prod(rgrid))
            x = torch.cat([xl.reshape(b, nl, dim), xr.reshape(b, nr, dim),
                           xg.reshape(b, 1, dim)], dim=1)
            for blk in stage.blocks:
                x = blk(x, nl, nr)
            xl = stage.downsample_local(x[:, :nl].reshape(b, *lgrid, dim))
            xr = stage.downsample_region(
                x[:, nl:nl + nr].reshape(b, *rgrid, dim))
            xg = linear(x[:, nl + nr:], stage.downsample_global)
            outputs.append(getattr(self, f"norm{i}")(xl))
        return outputs
