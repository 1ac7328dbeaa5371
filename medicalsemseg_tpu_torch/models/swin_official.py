"""MONAI's SwinUNETR and its Swin blocks (counterpart of
medicalsemseg_tpu/models/swin_official.py).

The blocks differ from the flagship's in ways the JAX module keeps so that
MONAI checkpoints carry over:

* per-axis windows and shifts: at a grid no larger than the constructor
  window along an axis the window is clamped to the grid there and that
  axis's shift set to 0 (``resolve_window_official``); the grid is then
  zero-padded up to the window;
* the bias table is the constructor window's, and its index is the
  constructor window's sliced ``[:n, :n]`` at a clamped window of n tokens;
* the shifted-window mask is MONAI's region-id ``compute_mask`` over the
  padded grid.

:class:`OfficialSwinBlock` takes the JAX block's three routes and its one
switch: with the kernels on (``fused``: VideoSwinUNETR always,
SwinUNETR_Official under ``MEDSEG_OFFICIAL_FUSED=1``, read by the factory)
and in ``eval()`` mode, attention runs kernel K1 on the pre-gathered sliced
bias, with the LayerNorm and the shortcut inside when the grid needs no
padding (padding raw tokens would LN them to the LN bias), outside
otherwise, and the MLP runs K2; in training, or with the kernels off, the
attention and the MLP are the module's plain PyTorch, as the JAX block runs
XLA there. K1 has no backward here (the JAX block has none either): with
gradients enabled in eval mode with the kernels on, the block raises.

:class:`OfficialPatchMerging` keeps MONAI v1's duplicated-octant quirk;
:class:`SwinViTOfficial` normalises every hidden state with a
parameterless LayerNorm (``proj_out``); :class:`SwinUNETROfficial` puts
MONAI's 5-level UNETR decoder on it. Module names follow MONAI's state_dict
(``swinViT.layers1.0.blocks.0.attn.qkv``, ``encoder1.layer``,
``decoder5.transp_conv``, ``out.conv``), the MLP's dense layers
``fc1`` / ``fc2``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medicalsemseg_tpu_torch.models.decoders import (
    UnetOutBlock,
    UnetrBasicBlock,
    UnetrUpBlock,
)
from medicalsemseg_tpu_torch.models.layers import (
    Conv3d,
    DropPath,
    LayerNorm,
    Mlp,
    linear,
)
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa
from medicalsemseg_tpu_torch.ops.window import (
    _full_window_index,
    gather_rel_bias,
    pad_to_multiple,
    resolve_window_official,
    roll3,
    shift_mask,
    window_partition,
    window_reverse,
)

Tuple3 = Tuple[int, int, int]

_EVAL_GRAD = ("an official Swin block with the kernels on runs kernel K1 "
              "in eval mode, which has no backward kernel here: call the "
              "model under torch.inference_mode() or torch.no_grad(), or in "
              "train() mode for the differentiable plain form")


class OfficialWindowAttention(nn.Module):
    """W-MSA / SW-MSA over per-axis windows with the constructor window's
    (L, nh) bias table, its index sliced ``[:n, :n]`` at a window of n
    tokens: :meth:`forward` through K1, :meth:`plain` in PyTorch."""

    def __init__(self, dim: int, num_heads: int, window: Tuple3,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        rows = int(np.prod([2 * w - 1 for w in window]))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(rows, num_heads))
        idx = _full_window_index(tuple(window)).astype(np.int64)
        self.register_buffer("rel_index", torch.from_numpy(idx),
                             persistent=False)

    def bias(self, n: int) -> torch.Tensor:
        """(nh, n, n) fp32 bias of a window of n tokens."""
        return gather_rel_bias(self.relative_position_bias_table,
                               self.rel_index[:n, :n].reshape(-1), n)

    def forward(self, wins: torch.Tensor, grid_dims: Tuple3, ws: Tuple3,
                ss: Tuple3, ln: Optional[torch.Tensor] = None,
                residual: bool = False) -> torch.Tensor:
        """K1 on windows (T, N, C) of the rolled volume (raw with ``ln``,
        else LN'd), the window grid ``grid_dims`` of one volume."""
        dt = wins.dtype
        return kwa.window_attention(
            wins, self.qkv.weight.to(dt),
            None if self.qkv.bias is None else self.qkv.bias.float(),
            self.proj.weight.to(dt), self.proj.bias.float(),
            self.bias(wins.shape[1]), grid_dims=grid_dims, window=ws,
            shift=ss, ln=ln, residual=residual)

    def plain(self, wins: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Attention of LN'd windows (T, N, C) as the JAX module's XLA
        branch computes it (qkv and ``q * scale`` in the compute dtype, fp32
        logits + bias + the shift ``mask`` (nW, N, N), fp32 softmax rounded
        to the compute dtype, P.V and the projection in it), in PyTorch ops
        that autograd differentiates."""
        dt = wins.dtype
        t, n, c = wins.shape
        nh = self.num_heads
        hd = c // nh
        qkv = linear(wins, self.qkv).reshape(t, n, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = torch.matmul((q * hd ** -0.5).float(),
                            k.float().transpose(-1, -2))
        attn = attn + self.bias(n)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(t // nw, nw, nh, n, n)
                    + mask[None, :, None]).reshape(t, nh, n, n)
        p = torch.softmax(attn, dim=-1).to(dt)
        out = torch.matmul(p, v).permute(0, 2, 1, 3).reshape(t, n, c)
        return linear(out, self.proj)


class OfficialSwinBlock(nn.Module):
    """Pre-norm Swin block over (B, D, H, W, C) with the runtime window
    clamp. ``fused`` says whether the block runs the kernels in eval mode
    (see the module docstring for the routes)."""

    def __init__(self, dim: int, num_heads: int, window: Tuple3,
                 shift: Tuple3, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0,
                 fused: bool = False):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.fused = fused
        self.norm1 = LayerNorm(dim)
        self.attn = OfficialWindowAttention(dim, num_heads, window, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        ws, ss = resolve_window_official((d, h, w), self.window, self.shift)
        dp, hp, wp = (v + (-v) % s for v, s in zip((d, h, w), ws))
        grid_dims = (dp // ws[0], hp // ws[1], wp // ws[2])
        back = tuple(-s for s in ss)
        fuse = self.fused and not self.training
        if fuse and torch.is_grad_enabled():
            raise NotImplementedError(_EVAL_GRAD)
        if fuse and (dp, hp, wp) == (d, h, w):
            wins = window_partition(roll3(x, back), ws).contiguous()
            out = self.attn(wins, grid_dims, ws, ss, ln=self.norm1.params(),
                            residual=True)
            x = roll3(window_reverse(out, ws, (d, h, w)), ss)
        else:
            xn = roll3(pad_to_multiple(self.norm1(x), ws), back)
            wins = window_partition(xn, ws)
            if fuse:
                out = self.attn(wins.contiguous(), grid_dims, ws, ss)
            else:
                mask = (shift_mask((dp, hp, wp), ws, ss, x.device)
                        if any(ss) else None)
                out = self.attn.plain(wins, mask)
            xn = roll3(window_reverse(out, ws, (dp, hp, wp)), ss)
            x = x + self.drop_path(xn[:, :d, :h, :w, :])
        if fuse:
            return self.mlp(x.reshape(-1, c), self.norm2.params(),
                            residual=True).reshape(b, d, h, w, c)
        return x + self.drop_path(self.mlp.plain(self.norm2(x)))


def _octants(x: torch.Tensor, order) -> torch.Tensor:
    return torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in order], dim=-1)


class OfficialPatchMerging(nn.Module):
    """MONAI v1 patch merging: odd grids zero-padded, eight strided slices
    concatenated -> LN(8C) -> dense to 2C without bias, the slices in the
    reference's order, in which the 6th and 7th repeat the 3rd and 4th
    (octants (1, 1, 0) and (0, 1, 1) are never read)."""

    ORDER = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1),
             (0, 1, 0), (0, 0, 1), (1, 1, 1))

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(8 * dim)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, d, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        return linear(self.norm(_octants(x, self.ORDER)), self.reduction)


class ConvPatchEmbed(nn.Module):
    """A kernel = stride = patch conv without padding (a remainder of the
    grid is dropped), optionally followed by LayerNorm."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: Tuple3,
                 norm: bool = False):
        super().__init__()
        patch = tuple(int(p) for p in patch_size)
        self.proj = Conv3d(in_chans, embed_dim, patch, stride=patch,
                           padding=0)
        if norm:
            self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x)
        return self.norm(x) if hasattr(self, "norm") else x


class OfficialStage(nn.Module):
    """``depth`` blocks alternating unshifted and shifted by window // 2,
    then the patch merging ``merging(dim)``."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: Tuple3,
                 mlp_ratio: float, qkv_bias: bool,
                 drop_path_rates: Sequence[float], fused: bool,
                 merging: Callable[[int], nn.Module]):
        super().__init__()
        shift = tuple(w // 2 for w in window)
        self.blocks = nn.ModuleList([
            OfficialSwinBlock(dim, num_heads, window,
                              (0, 0, 0) if i % 2 == 0 else shift, mlp_ratio,
                              qkv_bias, drop_path_rates[i], fused)
            for i in range(depth)])
        self.downsample = merging(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


def _proj_out(x: torch.Tensor) -> torch.Tensor:
    """The parameterless LayerNorm over channels (fp32 statistics, the
    two-pass variance of ``F.layer_norm``)."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-5).to(x.dtype)


class SwinViTOfficial(nn.Module):
    """MONAI's swinViT: patch embedding and four stages with the patch
    merging at the end of each; returns [x0 .. x4], each normalised by
    :func:`_proj_out` when ``normalize``."""

    def __init__(self, in_chans: int = 1, embed_dim: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window: Tuple3 = (7, 7, 7), patch_size: Tuple3 = (2, 2, 2),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0, normalize: bool = True,
                 fused: bool = False):
        super().__init__()
        self.normalize = normalize
        self.patch_embed = ConvPatchEmbed(in_chans, embed_dim, patch_size)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.num_layers = len(depths)
        for k, depth in enumerate(depths):
            self.add_module(f"layers{k + 1}", nn.ModuleList([OfficialStage(
                embed_dim * 2 ** k, depth, num_heads[k], tuple(window),
                mlp_ratio, qkv_bias, dpr[sum(depths[:k]):sum(depths[:k + 1])],
                fused, OfficialPatchMerging)]))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        def proj_out(v):
            return _proj_out(v) if self.normalize else v

        x = self.patch_embed(x)
        outs = [proj_out(x)]
        for k in range(self.num_layers):
            x = getattr(self, f"layers{k + 1}")[0](x)
            outs.append(proj_out(x))
        return outs


class SwinUNETROfficial(nn.Module):
    """MONAI's SwinUNETR: swinViT and the 5-level UNETR decoder (residual
    encoders on the raw volume, x0, x1, x2 and x4; up-blocks from x4 back
    to full resolution). forward((vol, crop_loc, affine)) -> (B, D, H, W,
    n_classes) fp32 logits."""

    def __init__(self, out_channels: int, in_chans: int = 1,
                 feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 drop_path_rate: float = 0.0, normalize: bool = True,
                 fused: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        fs = feature_size
        self.swinViT = SwinViTOfficial(
            in_chans, fs, depths, num_heads, drop_path_rate=drop_path_rate,
            normalize=normalize, fused=fused)
        self.encoder1 = UnetrBasicBlock(in_chans, fs, fusable=False)
        self.encoder2 = UnetrBasicBlock(fs, fs, fusable=False)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs, fusable=False)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs, fusable=False)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs, fusable=False)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs, fusable=False)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs, fusable=False)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs, fusable=False)
        self.decoder2 = UnetrUpBlock(2 * fs, fs, fusable=False)
        self.decoder1 = UnetrUpBlock(fs, fs, fusable=False)
        self.out = UnetOutBlock(fs, out_channels)

    def forward(self, x_in: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                ) -> torch.Tensor:
        vol = x_in[0].to(self.dtype)
        z = self.swinViT(vol)
        x = self.decoder5(self.encoder10(z[4]), z[3])
        x = self.decoder4(x, self.encoder4(z[2]))
        x = self.decoder3(x, self.encoder3(z[1]))
        x = self.decoder2(x, self.encoder2(z[0]))
        return self.out(self.decoder1(x, self.encoder1(vol)))
