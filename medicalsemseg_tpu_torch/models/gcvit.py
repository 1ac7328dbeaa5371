"""GC-ViT 3D encoder (counterpart of medicalsemseg_tpu/models/gcvit.py: SE,
_ConvSE, FeatExtract, ReduceSize, GCWindowAttention, GCViTBlock, GCViTLayer,
GCViT3D), at inference and in training.

A 3^3 stride-2 conv stem, then four stages that alternate local window
attention (kernel K1, no shift) and global-query window attention (kernel
K6: queries from the stage's FeatExtract pyramid, one ws^3 grid per batch
element, keys and values from each window), each followed by the token MLP
(kernel K2, hidden 3C) and a ReduceSize downsampling. Returns the 5-scale
pyramid [stem@R/2, s1@R/4, ..., s4@R/32]. As in the JAX package, the bias
index is the standard (2w-1)-strided one unless ``ref_quirk_index`` asks for
the reference's colliding strides, and the global queries are per batch
element.

Every block runs the JAX block's absorbed form: the kernels apply LN1 / LN2
to the raw tokens and add the shortcut (outside the kernel, around the
dropped branch, in training with a live DropPath). That needs a grid that is
a multiple of the window, which the JAX model needs too (its window
partition is a plain reshape). In training the local blocks run K1 forward
and K3 backward (``WindowAttentionFn``, the reference-quirk index too: its
bias gradient reaches the table through the same ``index_add_``) and the
MLPs K2 and K4 (``FusedMlpFn``). K6 has no backward kernel, in the JAX
package either: in training a global block runs the module's own unfused
attention, the counterpart of the JAX block's XLA branch (LN1 outside, q
from the pyramid, kv dense, fp32 logits and softmax, . V, proj, shortcut
outside), and autograd differentiates it and the query pyramid; in eval mode
it runs K6 and refuses to run with gradients enabled. Layer scale, which the
factory never sets, is not ported. Module names follow the JAX scopes
(``levels.{i}.blocks.{j}.attn``, ``levels.{i}.to_q_global.{k}``,
``levels.{i}.downsample``).
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
    Mlp,
    linear,
    to_ncdhw,
    to_ndhwc,
)
from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa
from medicalsemseg_tpu_torch.ops.resize import resize_linear
from medicalsemseg_tpu_torch.ops.window import (
    gather_rel_bias,
    relative_position_index,
    relative_position_index_ref_quirk,
    window_partition,
    window_reverse,
)

Tuple3 = Tuple[int, int, int]

_EVAL_GRAD = ("a global-query block in eval mode runs kernel K6, which has no "
              "backward kernel: call the model under torch.inference_mode() "
              "or torch.no_grad(), or in train() mode for the differentiable "
              "unfused form")


class SE(nn.Module):
    """Squeeze-excitation gate: spatial mean -> fc -> GELU -> fc -> sigmoid."""

    def __init__(self, dim: int, expansion: float = 0.25):
        super().__init__()
        self.fc1 = nn.Linear(dim, int(dim * expansion), bias=False)
        self.fc2 = nn.Linear(int(dim * expansion), dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float().mean(dim=(1, 2, 3)).to(x.dtype)
        y = torch.sigmoid(linear(F.gelu(linear(y, self.fc1)), self.fc2))
        return x * y[:, None, None, None, :]


class ConvSE(nn.Module):
    """x + 1x1(SE(GELU(depthwise 3^3(x)))), shared by FeatExtract and
    ReduceSize (the JAX ``_ConvSE``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv3d(dim, dim, 3, bias=False, groups=dim)
        self.se = SE(dim)
        self.pwconv = Conv3d(dim, dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pwconv(self.se(F.gelu(self.dwconv(x))))


class FeatExtract(nn.Module):
    """conv-SE residual, then (unless ``keep_dim``) a 3^3 max pool with
    per-axis strides and padding 1: a stride-1 axis keeps its size."""

    def __init__(self, dim: int, keep_dim: bool = False,
                 pool_strides: Tuple3 = (2, 2, 2)):
        super().__init__()
        self.keep_dim, self.pool_strides = keep_dim, tuple(pool_strides)
        self.conv_se = ConvSE(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_se(x)
        if self.keep_dim:
            return x
        return to_ndhwc(F.max_pool3d(to_ncdhw(x), 3, stride=self.pool_strides,
                                     padding=1))


class ReduceSize(nn.Module):
    """LN -> conv-SE residual -> 3^3 stride-2 conv (pad 1) doubling the
    channels -> LN."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.conv_se = ConvSE(dim)
        self.reduction = Conv3d(dim, 2 * dim, 3, stride=2, padding=1,
                                bias=False)
        self.norm2 = LayerNorm(2 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm2(self.reduction(self.conv_se(self.norm1(x))))


class GCWindowAttention(nn.Module):
    """Local (``qkv``: C -> 3C, kernel K1; K3 backward) or global-query
    (``qkv``: C -> 2C for K and V, kernel K6 in eval mode; :meth:`unfused`
    in training) window attention with a relative-position bias."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 use_global: bool, qkv_bias: bool = True,
                 ref_quirk_index: bool = False):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.use_global = use_global
        self.qkv = nn.Linear(dim, (2 if use_global else 3) * dim,
                             bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 3, num_heads))
        index_fn = (relative_position_index_ref_quirk if ref_quirk_index
                    else relative_position_index)
        idx = index_fn((window_size,) * 3).astype(np.int64)
        self.register_buffer("rel_index", torch.from_numpy(idx).reshape(-1),
                             persistent=False)

    def gathered_bias(self) -> torch.Tensor:
        """(nh, N, N) fp32 bias gathered from the table, with the standard
        index or the reference's (the kernels take either as it is)."""
        return gather_rel_bias(self.relative_position_bias_table,
                               self.rel_index, self.window_size ** 3)

    def forward(self, wins: torch.Tensor, q_global: torch.Tensor,
                grid_dims: Tuple3, ln: torch.Tensor,
                residual: bool = True) -> torch.Tensor:
        """Raw windows (T, N, C) -> [wins +] attn(LN(wins)) through the
        kernels; ``q_global`` (B, N, C) is read by the global form only,
        which has no backward and refuses gradients (see :meth:`unfused`)."""
        dt = wins.dtype
        ws = self.window_size
        qkv_b = None if self.qkv.bias is None else self.qkv.bias.float()
        if self.use_global:
            if torch.is_grad_enabled():
                raise NotImplementedError(_EVAL_GRAD)
            return kga.global_window_attention(
                wins, q_global.to(dt).contiguous(), self.qkv.weight.to(dt),
                qkv_b, self.proj.weight.to(dt), self.proj.bias.float(),
                self.gathered_bias(), ln=ln, residual=residual)
        if torch.is_grad_enabled():
            return kwa.WindowAttentionFn.apply(
                wins, ln, self.qkv.weight, self.qkv.bias, self.proj.weight,
                self.proj.bias, self.relative_position_bias_table,
                self.rel_index, grid_dims, (ws,) * 3, (0, 0, 0), 1e-5,
                residual)
        return kwa.window_attention(
            wins, self.qkv.weight.to(dt), qkv_b, self.proj.weight.to(dt),
            self.proj.bias.float(), self.gathered_bias(), grid_dims=grid_dims,
            window=(ws,) * 3, shift=(0, 0, 0), ln=ln, residual=residual)

    def unfused(self, wins: torch.Tensor,
                q_global: torch.Tensor) -> torch.Tensor:
        """The global-query attention of LN'd windows (T, N, C) as the JAX
        module's XLA branch computes it (``q * scale`` in the compute dtype,
        fp32 logits + bias, fp32 softmax rounded to the compute dtype, . V
        and proj in it), in PyTorch ops that autograd differentiates."""
        dt = wins.dtype
        t, n, c = wins.shape
        nh = self.num_heads
        hd = c // nh
        kv = linear(wins, self.qkv).reshape(t, n, 2, nh, hd)
        k, v = kv.permute(2, 0, 3, 1, 4).unbind(0)
        # one query grid per batch element
        qg = q_global.to(dt).repeat_interleave(t // q_global.shape[0], dim=0)
        q = qg.reshape(t, n, nh, hd).permute(0, 2, 1, 3)
        attn = torch.matmul((q * hd ** -0.5).float(),
                            k.float().transpose(-1, -2))
        attn = torch.softmax(attn + self.gathered_bias()[None], dim=-1)
        out = torch.matmul(attn.to(dt), v)
        return linear(out.permute(0, 2, 1, 3).reshape(t, n, c), self.proj)


class GCViTBlock(nn.Module):
    """LN -> (local | global) window attention -> LN -> MLP over
    (B, D, H, W, C), both halves with the LayerNorm inside the kernel and
    the shortcut inside too but in training with a live DropPath; a global
    block in training runs :meth:`GCWindowAttention.unfused` with LN1 and
    the shortcut outside, as the JAX block's XLA branch does."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 use_global: bool, mlp_ratio: float = 3.0,
                 qkv_bias: bool = True, ref_quirk_index: bool = False,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = GCWindowAttention(dim, num_heads, window_size, use_global,
                                      qkv_bias, ref_quirk_index)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, q_global: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        ws = self.attn.window_size
        if d % ws or h % ws or w % ws:
            raise ValueError(f"grid {(d, h, w)} is no multiple of the window "
                             f"{ws}")
        grid_dims = (d // ws, h // ws, w // ws)
        res_in = not (self.training and self.drop_path.rate > 0.0)
        if self.attn.use_global and self.training:
            out = self.attn.unfused(window_partition(self.norm1(x), ws),
                                    q_global)
            x = x + self.drop_path(window_reverse(out, ws, (d, h, w)))
        else:
            out = self.attn(window_partition(x, ws).contiguous(), q_global,
                            grid_dims, self.norm1.params(), residual=res_in)
            out = window_reverse(out, ws, (d, h, w))
            x = out if res_in else x + self.drop_path(out)
        y = self.mlp(x.reshape(-1, c), self.norm2.params(), residual=res_in)
        y = y.reshape(b, d, h, w, c)
        return y if res_in else x + self.drop_path(y)


def _pool_plan(resolution: Tuple3, ws: int) -> List[Tuple3]:
    """Pool strides of the stage's FeatExtract pyramid, which halves each
    axis floor(log2(size // ws)) times; empty when no axis is halved."""
    n_per_axis = [max(int(np.floor(np.log2(max(s // ws, 1)))), 0)
                  for s in resolution]
    return [tuple(2 if i < n else 1 for n in n_per_axis)
            for i in range(max(n_per_axis))]


class GCViTLayer(nn.Module):
    """A stage: the global-query pyramid, ``depth`` blocks alternating local
    and global attention, then ReduceSize. ``resolution`` is the stage's
    input grid: the pyramid's depth, and with it the parameter tree, depends
    on it, as in the JAX model at init."""

    def __init__(self, dim: int, resolution: Tuple3, depth: int,
                 num_heads: int, window_size: int, mlp_ratio: float = 3.0,
                 qkv_bias: bool = True, ref_quirk_index: bool = False,
                 drop_path_rates: Sequence[float] = (0.0,)):
        super().__init__()
        self.resolution = tuple(resolution)
        self.window = min(window_size, min(resolution))
        plan = _pool_plan(self.resolution, self.window)
        self.to_q_global = nn.ModuleList(
            [FeatExtract(dim, pool_strides=p) for p in plan]
            or [FeatExtract(dim, keep_dim=True)])
        self.blocks = nn.ModuleList([
            GCViTBlock(dim, num_heads, self.window, i % 2 == 1, mlp_ratio,
                       qkv_bias, ref_quirk_index, drop_path_rates[i])
            for i in range(depth)])
        self.downsample = ReduceSize(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:4]) != self.resolution:
            raise ValueError(f"stage built for grid {self.resolution}, got "
                             f"{tuple(x.shape[1:4])}")
        ws = self.window
        q = x
        for extract in self.to_q_global:
            q = extract(q)
        if tuple(q.shape[1:4]) != (ws, ws, ws):
            # axis ratios that are no power of two: linear resize to ws^3,
            # antialiased where it shrinks
            q = resize_linear(q, (ws, ws, ws))
        q = q.reshape(q.shape[0], ws ** 3, q.shape[-1])
        for blk in self.blocks:
            x = blk(x, q)
        return self.downsample(x)


class GCViT3D(nn.Module):
    """The full encoder. ``img_size`` is the input's spatial size (the
    sliding-window roi)."""

    def __init__(self, img_size: Tuple3, in_chans: int = 1, dim: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_sizes: Sequence[int] = (6, 6, 6, 6),
                 mlp_ratio: float = 3.0, qkv_bias: bool = True,
                 ref_quirk_index: bool = False, drop_path_rate: float = 0.2):
        super().__init__()
        self.patch_embed = Conv3d(in_chans, dim, 3, stride=2, padding=1)
        grid = tuple((s - 1) // 2 + 1 for s in img_size)
        # stochastic depth rising linearly over the blocks, as in JAX
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.levels = nn.ModuleList()
        for i in range(len(depths)):
            self.levels.append(GCViTLayer(
                dim * 2 ** i, grid, depths[i], num_heads[i], window_sizes[i],
                mlp_ratio, qkv_bias, ref_quirk_index,
                dpr[sum(depths[:i]):sum(depths[:i + 1])]))
            self.add_module(f"norm{i}", LayerNorm(dim * 2 ** (i + 1)))
            grid = tuple((g - 1) // 2 + 1 for g in grid)

    def forward(self, vol: torch.Tensor, crop_loc=None,
                affine=None) -> List[torch.Tensor]:
        """The pyramid of ``vol``; ``crop_loc`` and ``affine`` are not read
        (the encoders' common signature)."""
        x = self.patch_embed(vol)
        outputs = [x]
        for i, level in enumerate(self.levels):
            x = level(x)
            outputs.append(getattr(self, f"norm{i}")(x))
        return outputs
