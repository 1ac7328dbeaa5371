"""3D shifted-window transformer encoders (counterpart of
medicalsemseg_tpu/models/swin.py: make_mlp, WindowAttention, SwinBlock,
PatchMerging, BasicLayer, SwinEncoder3D). One skeleton covers the three
encoders that differ in their token MLP: the flagship's dense MLP
(``nnFormerUNETR``, ``SwinSegFormer``), SwInception's inception convs and
SwinDepth's depthwise convs; and the encoder's options (learned class
vectors, the relative crop position, the affine-scaled relative-position
bias, the fixed sin-cos position table, the global token).

Attention runs the hand-written kernels (K1, backward K3) in every block
but those built with ``rel_pos_bias_affine`` or ``global_token``: the JAX
block leaves its fused kernel for exactly these two options, and the port's
block chooses :meth:`WindowAttention.unfused` (plain PyTorch, at inference
and in training) by them alone. The dense MLP runs K2 (backward K4) in every
block; the inception and depthwise MLPs are plain PyTorch, as the JAX
package runs XLA there. ``model.eval()`` gives the JAX block's inference
form (shortcuts inside the kernels), ``model.train()`` its training form
(shortcuts outside the kernels when DropPath is live). Module and parameter
names follow the reference state_dict keys that
``medicalsemseg_tpu/utils/torch_import.py`` reads
(``layers.{i}.blocks.{j}.attn.qkv``, ``lcv.fc``, ``rel_crop_pos_emb``,
``global_token``, ``layers.{i}.gt_upsample`` and so on).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medicalsemseg_tpu_torch.models.embeddings import (
    LearnedClassVectors,
    PatchEmbed3D,
    get_3d_sincos_pos_embed,
)
from medicalsemseg_tpu_torch.models.layers import (
    Conv3d,
    DepthwiseConvMlp,
    DropPath,
    InceptionMlp,
    LayerNorm,
    Mlp,
    checkpoint_block,
    linear,
)
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa
from medicalsemseg_tpu_torch.ops.window import (
    gather_rel_bias,
    pad_to_multiple,
    relative_position_index,
    relative_position_index_ref_quirk,
    resolve_window,
    roll3,
    shift_mask,
    window_partition,
    window_reverse,
)

Tuple3 = Tuple[int, int, int]


def make_mlp(mlp_type: str, dim: int, hidden: int) -> nn.Module:
    """The block's token MLP: ``dense`` (K2 / K4), ``inception`` or
    ``dwconv``."""
    if mlp_type == "dense":
        return Mlp(dim, hidden)
    if mlp_type == "inception":
        return InceptionMlp(dim, hidden)
    if mlp_type == "dwconv":
        return DepthwiseConvMlp(dim, hidden)
    raise ValueError(f"unknown mlp_type {mlp_type!r}")


class WindowAttention(nn.Module):
    """W-MSA / SW-MSA over cubic windows with a relative-position bias.

    ``rel_pos_bias_affine`` adds a bias scaled by the volume's voxel
    spacing (``rel_pos_bias_affine_emb``, a (L, nh, 3) table, mixed by the
    fp32 dense ``rel_pos_bias_affine_lin``); ``global_token`` appends one
    shared token to every window and mixes the windows' copies of it back
    into one with ``gt_proj``, a dense layer over the ``n_windows`` windows
    of a volume. Either option makes the block run :meth:`unfused`.
    ``ref_quirk_index`` gathers every bias (and scatters the kernels' bias
    gradient) with the reference's colliding-stride index
    (``relative_position_index_ref_quirk``) instead of the standard one."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = False, n_windows: int = 1,
                 rel_pos_bias_affine: bool = False,
                 global_token: bool = False, ref_quirk_index: bool = False):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.n_windows = n_windows
        self.rel_pos_bias_affine, self.global_token = (rel_pos_bias_affine,
                                                       global_token)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        rows = (2 * window_size - 1) ** 3
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(rows, num_heads))
        index_fn = (relative_position_index_ref_quirk if ref_quirk_index
                    else relative_position_index)
        idx = index_fn((window_size,) * 3).astype(np.int64)
        self.register_buffer("rel_index", torch.from_numpy(idx).reshape(-1),
                             persistent=False)
        if rel_pos_bias_affine:
            self.rel_pos_bias_affine_emb = nn.Parameter(
                torch.zeros(rows, num_heads, 3))
            self.rel_pos_bias_affine_lin = nn.Linear(3, 1)
        if global_token:
            self.gt_proj = nn.Linear(n_windows, 1)

    @property
    def fused(self) -> bool:
        """Whether the block runs the kernels (no option of the unfused
        form is set)."""
        return not (self.rel_pos_bias_affine or self.global_token)

    def gathered_bias(self) -> torch.Tensor:
        """(nh, N, N) fp32 bias gathered from the table."""
        return gather_rel_bias(self.relative_position_bias_table,
                               self.rel_index, self.window_size ** 3)

    def affine_bias(self, affine: torch.Tensor) -> torch.Tensor:
        """(B, nh, N, N) fp32 bias of each volume's voxel spacing
        ``affine`` (B, 3): the dense layer over the three spacing-scaled
        table entries, as the JAX module applies it to every window."""
        n = self.window_size ** 3
        nh = self.num_heads
        table = self.rel_pos_bias_affine_emb.float()[self.rel_index]
        scaled = table[None] * affine.float()[:, None, None, :]
        lin = self.rel_pos_bias_affine_lin
        out = F.linear(scaled, lin.weight.float(), lin.bias.float())[..., 0]
        return out.reshape(-1, n, n, nh).permute(0, 3, 1, 2)

    def forward(self, wins: torch.Tensor, grid_dims: Tuple3, shift: int,
                ln=None, residual: bool = False) -> torch.Tensor:
        dt = wins.dtype
        ws = self.window_size
        if torch.is_grad_enabled():
            return kwa.WindowAttentionFn.apply(
                wins.contiguous(), ln, self.qkv.weight, self.qkv.bias,
                self.proj.weight, self.proj.bias,
                self.relative_position_bias_table, self.rel_index, grid_dims,
                (ws,) * 3, (shift,) * 3, 1e-5, residual)
        return kwa.window_attention(
            wins, self.qkv.weight.to(dt),
            None if self.qkv.bias is None else self.qkv.bias.float(),
            self.proj.weight.to(dt), self.proj.bias.float(),
            self.gathered_bias(), grid_dims=grid_dims, window=(ws,) * 3,
            shift=(shift,) * 3, ln=ln, residual=residual)

    def unfused(self, wins: torch.Tensor, mask: Optional[torch.Tensor],
                affine: Optional[torch.Tensor] = None,
                gt: Optional[torch.Tensor] = None):
        """Attention of LN'd windows (T, N, C) as the JAX module's XLA
        branch computes it (qkv and ``q * scale`` in the compute dtype, fp32
        logits + biases + the shift ``mask`` (nW, N, N), fp32 softmax
        rounded to the compute dtype, P.V and the projection in it), in
        PyTorch ops that autograd differentiates. The affine bias is added
        only when ``affine`` (B, 3) is given; ``gt`` (B, 1, 1, C) is the
        global token, required with ``global_token``. Returns (windows, the
        new global token or None)."""
        dt = wins.dtype
        t, n0, c = wins.shape
        nh = self.num_heads
        hd = c // nh
        x, n = wins, n0
        if self.global_token:
            if gt is None:
                raise ValueError("a global-token block needs the token")
            b = gt.shape[0]
            gtw = gt.reshape(b, 1, c).to(dt).repeat_interleave(t // b, dim=0)
            x, n = torch.cat([x, gtw], dim=1), n0 + 1
        pad = (0, n - n0, 0, n - n0)
        qkv = linear(x, self.qkv).reshape(t, n, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = torch.matmul((q * hd ** -0.5).float(),
                            k.float().transpose(-1, -2))
        attn = attn + F.pad(self.gathered_bias(), pad)[None]
        if self.rel_pos_bias_affine and affine is not None:
            rpba = F.pad(self.affine_bias(affine), pad)
            b = rpba.shape[0]
            attn = (attn.reshape(b, t // b, nh, n, n)
                    + rpba[:, None]).reshape(t, nh, n, n)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(t // nw, nw, nh, n, n)
                    + F.pad(mask, pad)[None, :, None]).reshape(t, nh, n, n)
        p = torch.softmax(attn, dim=-1).to(dt)
        out = torch.matmul(p, v).permute(0, 2, 1, 3).reshape(t, n, c)
        out = linear(out, self.proj)
        if not self.global_token:
            return out, None
        g = out[:, n0].reshape(-1, self.n_windows, c).transpose(1, 2)
        new_gt = linear(g, self.gt_proj)[..., 0].reshape(-1, 1, 1, c)
        return out[:, :n0], new_gt


class SwinBlock(nn.Module):
    """One W-MSA/SW-MSA block plus token MLP over (B, D, H, W, C), in the
    forms of the JAX SwinBlock with the fused kernels.

    When the grid is a multiple of the window (every flagship stage at roi
    96) the block takes the absorbed form: the kernel applies LN1 to the raw
    rolled volume. It also adds the shortcut itself, except in training with
    a live DropPath (``drop_path_rate > 0``): then the shortcut is added
    outside, around the dropped branch. Otherwise LN1 runs outside, the
    volume is zero-padded, and the shortcut is added after the crop (padding
    raw tokens would LN them to the LN bias, not to 0). A block with
    ``rel_pos_bias_affine`` or ``global_token`` takes that padded form with
    the unfused attention. The dense MLP always absorbs LN2, with its
    shortcut inside or outside by the same rule; the inception and
    depthwise MLPs take LN2 outside and the shortcut after them.

    ``forward(x, affine=None, gt=None)`` returns (the block's output, the
    new global token or None), as the JAX block does."""

    def __init__(self, dim: int, input_resolution: Tuple3, num_heads: int,
                 window_size: int, shift_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_path_rate: float = 0.0,
                 mlp_type: str = "dense", rel_pos_bias_affine: bool = False,
                 global_token: bool = False, ref_quirk_index: bool = False):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        ws, _ = resolve_window(input_resolution, window_size, shift_size)
        n_windows = int(np.prod([-(-r // ws) for r in input_resolution]))
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, ws, num_heads, qkv_bias, n_windows,
                                    rel_pos_bias_affine, global_token,
                                    ref_quirk_index)
        self.norm2 = LayerNorm(dim)
        self.mlp_type = mlp_type
        self.mlp = make_mlp(mlp_type, dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, affine: Optional[torch.Tensor] = None,
                gt: Optional[torch.Tensor] = None):
        b, d, h, w, c = x.shape
        ws, ss = resolve_window((d, h, w), self.window_size, self.shift_size)
        if ws != self.attn.window_size:
            raise ValueError(
                f"grid {(d, h, w)} resolves to window {ws}, but the block was "
                f"built for window {self.attn.window_size}")
        dp, hp, wp = (v + (-v) % ws for v in (d, h, w))
        grid_dims = (dp // ws, hp // ws, wp // ws)
        res_in = not (self.training and self.drop_path.rate > 0.0)
        if not self.attn.fused:
            xn = roll3(pad_to_multiple(self.norm1(x), (ws,) * 3), -ss)
            mask = shift_mask((dp, hp, wp), ws, ss, x.device) if ss else None
            out, gt = self.attn.unfused(window_partition(xn, ws), mask,
                                        affine, gt)
            xn = roll3(window_reverse(out, ws, (dp, hp, wp)), ss)
            x = x + self.drop_path(xn[:, :d, :h, :w, :])
        elif (dp, hp, wp) == (d, h, w):
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
        if self.mlp_type == "dense":
            y = self.mlp(x.reshape(-1, c), self.norm2.params(),
                         residual=res_in).reshape(b, d, h, w, c)
            x = y if res_in else x + self.drop_path(y)
        else:
            y = self.mlp(self.norm2(x).reshape(b, -1, c), (d, h, w))
            x = x + self.drop_path(y.reshape(b, d, h, w, c))
        return x, gt


class PatchMerging(nn.Module):
    """Exact GELU -> LN -> 3^3 stride-2 conv (pad 1) doubling channels."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.reduction = Conv3d(dim, 2 * dim, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduction(self.norm(F.gelu(x)))


class BasicLayer(nn.Module):
    """A stage: ``depth`` alternating W-MSA / SW-MSA blocks, then merging;
    with ``global_token`` also ``gt_upsample``, the dense layer that widens
    the global token to the next stage's channels. Each block runs under
    the rematerialisation mode ``remat`` (``layers.checkpoint_block``; the
    JAX layer's ``remat_module(SwinBlock, remat)``)."""

    def __init__(self, dim: int, input_resolution: Tuple3, depth: int,
                 num_heads: int, window_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False,
                 drop_path_rates: Sequence[float] = (0.0,),
                 mlp_type: str = "dense", rel_pos_bias_affine: bool = False,
                 global_token: bool = False, ref_quirk_index: bool = False,
                 remat: str = "none"):
        super().__init__()
        self.remat = remat
        self.blocks = nn.ModuleList([
            SwinBlock(dim, input_resolution, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                      qkv_bias, drop_path_rates[i], mlp_type,
                      rel_pos_bias_affine, global_token, ref_quirk_index)
            for i in range(depth)])
        self.downsample = PatchMerging(dim)
        if global_token:
            self.gt_upsample = nn.Linear(dim, 2 * dim)

    def forward(self, x: torch.Tensor, affine: Optional[torch.Tensor] = None,
                gt: Optional[torch.Tensor] = None, downsample: bool = True):
        """(the stage output before merging, the merged output, the global
        token or None), as the JAX layer returns them; ``downsample=False``
        leaves the merging out (its result is then None), for a caller that
        does not read it."""
        for blk in self.blocks:
            x, gt = checkpoint_block(blk, self.remat, x, affine=affine, gt=gt)
        if gt is not None:
            gt = linear(gt, self.gt_upsample)
        return x, self.downsample(x) if downsample else None, gt


@functools.lru_cache(maxsize=None)
def _sincos_table(dim: int, grid: Tuple3, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """The (D, H, W, dim) sin-cos table in ``dtype`` on ``device``, made
    once per grid."""
    table = get_3d_sincos_pos_embed(dim, grid).astype(np.float32)
    return torch.from_numpy(table).reshape(*grid, dim).to(device, dtype)


class SwinEncoder3D(nn.Module):
    """nnFormer-style hierarchical encoder. ``forward(vol, crop_loc=None,
    affine=None)`` returns the 5-scale pyramid [stem, s1, s2, s3, s4], where
    s_i is the LayerNorm of the *downsampled* output of stage i.

    ``img_size`` is the input's spatial size (the sliding-window roi): the
    per-stage window clamp, and with it the shape of each bias table and
    the global token's window count, depends on the stage grids, as in the
    JAX model at init. The options are the JAX encoder's: learned class
    vectors (``lcv``, added to the patch embedding, concatenated with a
    patch embedding of ``embed_dim - lcv_vector_dim`` channels under
    ``lcv_concat_vector``, or alone under ``lcv_only``), ``rel_crop_pos_emb``
    (a dense layer of the crop's relative position ``crop_loc`` (B, 3),
    added to every token), ``abs_pos_emb`` (the fixed sin-cos table, added
    after the stem output is taken), ``rel_pos_bias_affine`` (reads the
    voxel spacing ``affine`` (B, 3)) and ``global_token`` (a learned token
    threaded through every block). ``remat`` is every block's
    rematerialisation mode (:class:`BasicLayer`)."""

    def __init__(self, img_size: Tuple3, patch_size: Tuple3 = (2, 2, 2),
                 in_chans: int = 1, embed_dim: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_sizes: Sequence[int] = (6, 6, 6, 6),
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 drop_path_rate: float = 0.0, mlp_type: str = "dense",
                 learned_cls_vectors: bool = False,
                 lcv_transform: Optional[Callable] = None,
                 lcv_vector_dim: int = 6, lcv_sincos_emb: bool = False,
                 lcv_final_layer: bool = False,
                 lcv_concat_vector: bool = False, lcv_only: bool = False,
                 lcv_linear_comb: bool = False,
                 lcv_patch_voxel_mean: bool = False,
                 rel_crop_pos_emb: bool = False,
                 rel_pos_bias_affine: bool = False,
                 abs_pos_emb: bool = False, global_token: bool = False,
                 remat: str = "none"):
        super().__init__()
        self.embed_dim = embed_dim
        self.lcv_concat_vector = lcv_concat_vector
        self.abs_pos_emb = abs_pos_emb
        pe_dim = embed_dim
        if learned_cls_vectors:
            lcv_out = lcv_vector_dim if lcv_concat_vector else embed_dim
            if lcv_concat_vector:
                pe_dim = embed_dim - lcv_out
            self.lcv = LearnedClassVectors(
                patch_size, lcv_out, lcv_vector_dim, lcv_transform,
                sincos_emb=lcv_sincos_emb, final_layer=lcv_final_layer,
                concat_vector=lcv_concat_vector, linear_comb=lcv_linear_comb,
                patch_voxel_mean=lcv_patch_voxel_mean)
        elif lcv_only:
            raise ValueError("--lcv_only needs --learned_cls_vectors")
        if not lcv_only:
            self.patch_embed = PatchEmbed3D(patch_size, in_chans, pe_dim)
        if rel_crop_pos_emb:
            self.rel_crop_pos_emb = nn.Linear(3, embed_dim)
        if global_token:
            self.global_token = nn.Parameter(torch.zeros(1, 1, 1, embed_dim))
        grid = tuple(-(-s // p) for s, p in zip(img_size, patch_size))
        # stochastic depth grows linearly over all blocks of the encoder
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList()
        for i in range(len(depths)):
            self.layers.append(BasicLayer(
                embed_dim * 2 ** i, grid, depths[i], num_heads[i],
                window_sizes[i], mlp_ratio, qkv_bias,
                dpr[sum(depths[:i]):sum(depths[:i + 1])], mlp_type,
                rel_pos_bias_affine, global_token, remat=remat))
            self.add_module(f"norm{i}", LayerNorm(embed_dim * 2 ** (i + 1)))
            grid = tuple(-(-g // 2) for g in grid)

    def embed(self, vol: torch.Tensor,
              crop_loc: Optional[torch.Tensor]) -> torch.Tensor:
        """The stem output: patch embedding and / or class vectors, plus
        the crop position's embedding."""
        x_cls = self.lcv(vol) if hasattr(self, "lcv") else None
        if not hasattr(self, "patch_embed"):
            x = x_cls
        else:
            x = self.patch_embed(vol)
            if x_cls is not None:
                x = (torch.cat([x, x_cls], dim=-1) if self.lcv_concat_vector
                     else x + x_cls)
        if hasattr(self, "rel_crop_pos_emb") and crop_loc is not None:
            rcpe = linear(crop_loc.to(x.dtype), self.rel_crop_pos_emb)
            x = x + rcpe[:, None, None, None, :]
        return x

    def forward(self, vol: torch.Tensor,
                crop_loc: Optional[torch.Tensor] = None,
                affine: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        x = self.embed(vol, crop_loc)
        gt = None
        if hasattr(self, "global_token"):
            gt = self.global_token.to(x.dtype).expand(x.shape[0], 1, 1,
                                                      self.embed_dim)
        outputs = [x]
        if self.abs_pos_emb:
            x = x + _sincos_table(self.embed_dim, tuple(x.shape[1:4]),
                                  x.device, x.dtype)
        for i, layer in enumerate(self.layers):
            _, x, gt = layer(x, affine, gt)
            outputs.append(getattr(self, f"norm{i}")(x))
        return outputs
