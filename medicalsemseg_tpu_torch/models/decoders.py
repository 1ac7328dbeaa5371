"""Segmentation decoders and the encoder + decoder models (counterpart of
medicalsemseg_tpu/models/decoders.py): the UNETR-style decoder (UnetResBlock,
UnetrUpBlock, UnetOutBlock, SwinUNETRDecoder, SwinUNETRCustom) and the
SegFormer all-MLP heads (_LinearEmbed, _FuseConv, SegFormerHead,
SegFormerHeadOfficial).

Module names follow MONAI's blocks as the reference model nests them
(``unet_encoders.{k}.layer.conv1.conv``, ``unet_decoders.{k}.transp_conv.conv``,
``out.conv.conv``), so a reference state_dict loads as it is. The 3^3 convs,
InstanceNorm and the transposed convs are plain PyTorch (cuDNN on the card),
as the JAX package leaves them to XLA by default; with
``MEDSEG_FUSED_DECODER=1`` the second conv of an eligible ``UnetResBlock``
takes kernel K9 with the norm before it folded in. The SegFormer heads follow
the JAX scopes (``linear_c{k}.proj``, ``linear_fuse[_k].{conv,bn}``,
``linear_pred``).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from medicalsemseg_tpu_torch.models.layers import (
    BatchNorm,
    Conv3d,
    ConvTranspose3d,
    Dropout,
    InstanceNorm,
    checkpoint_block,
    leaky_relu,
    linear,
)
from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9
from medicalsemseg_tpu_torch.ops.resize import resize_trilinear


def decoder_fuse_enabled(x: torch.Tensor) -> bool:
    """The fused decoder form (``MEDSEG_FUSED_DECODER``, read at call time,
    off by default) for an activation ``x``: on the card in any compute
    dtype. The JAX gate checks no dtype and its kernel computes in x's, so
    ``--compute_dtype float16 | float32`` fuse as bf16 does (K9 takes all
    three); the shape and channel window is ``winograd_f23_applicable`` in
    ``UnetResBlock._fused``. (A CPU tensor passes under the tests' hook
    ``winograd3d.ALLOW_CPU`` and runs K9's plain version.)"""
    if os.environ.get("MEDSEG_FUSED_DECODER", "0") == "0":
        return False
    return x.is_cuda or k9.ALLOW_CPU


class Convolution(nn.Module):
    """MONAI ``Convolution`` holder: the conv lives at ``.conv``."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UnetResBlock(nn.Module):
    """conv3-IN-lrelu -> conv3-IN, plus a 1x1-IN shortcut when the channel
    count changes, then lrelu.

    Fused form (``eval()`` without gradients, ``decoder_fuse_enabled``, the
    channel count inside K9's window), in the compute dtype of ``y``:
    ``norm1`` is reduced to its fp32 statistics, and ``conv2`` runs as
    kernel K9 with the normalize and LeakyReLU pass folded into its input as
    a per-(sample, channel) scale and shift, so the normalized volume is
    never written. ``fusable=False``
    keeps the block out of the fused form (the decoders of UNETR and
    SwinUNETR_Official: their JAX modules pass no ``fuse`` to them)."""

    def __init__(self, in_ch: int, out_ch: int, fusable: bool = True):
        super().__init__()
        self.fusable = fusable
        self.conv1 = Convolution(Conv3d(in_ch, out_ch, 3, bias=False))
        self.norm1 = InstanceNorm(out_ch)
        self.conv2 = Convolution(Conv3d(out_ch, out_ch, 3, bias=False))
        self.norm2 = InstanceNorm(out_ch)
        if in_ch != out_ch:
            self.conv3 = Convolution(Conv3d(in_ch, out_ch, 1, bias=False))
            self.norm3 = InstanceNorm(out_ch)

    def _fused(self, y: torch.Tensor) -> bool:
        return (self.fusable and not self.training
                and not torch.is_grad_enabled()
                and decoder_fuse_enabled(y)
                and k9.winograd_f23_applicable(tuple(y.shape[1:4]),
                                               y.shape[-1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        if self._fused(y):
            var, mu = torch.var_mean(y.float(), dim=(1, 2, 3), correction=0)
            sc = self.norm1.weight.float() * torch.rsqrt(var + self.norm1.eps)
            sh = self.norm1.bias.float() - mu * sc
            y = k9.winograd_conv3d_f23(
                y.contiguous(), self.conv2.conv.weight.to(y.dtype),
                epilogue=(sc, sh), lrelu=True)
        else:
            y = self.conv2(leaky_relu(self.norm1(y)))
        y = self.norm2(y)
        res = self.norm3(self.conv3(x)) if hasattr(self, "conv3") else x
        return leaky_relu(y + res)


class UnetrBasicBlock(nn.Module):
    """MONAI ``UnetrBasicBlock(res_block=True)``: the block at ``.layer``."""

    def __init__(self, in_ch: int, out_ch: int, fusable: bool = True):
        super().__init__()
        self.layer = UnetResBlock(in_ch, out_ch, fusable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """Transposed-conv upsample (kernel == stride, one factor or one per
    axis), concat skip, res block."""

    def __init__(self, in_ch: int, out_ch: int,
                 upsample: Union[int, Tuple[int, int, int]] = 2,
                 fusable: bool = True):
        super().__init__()
        self.transp_conv = Convolution(ConvTranspose3d(in_ch, out_ch, upsample))
        self.conv_block = UnetResBlock(2 * out_ch, out_ch, fusable)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.transp_conv(x)
        return self.conv_block(torch.cat([x, skip.to(x.dtype)], dim=-1))


class UnetOutBlock(nn.Module):
    """1x1x1 conv to class logits, returned in fp32."""

    def __init__(self, in_ch: int, n_classes: int):
        super().__init__()
        self.conv = Convolution(Conv3d(in_ch, n_classes, 1, bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x).float()


class SwinUNETRDecoder(nn.Module):
    """The UNETR decoder over the 5-scale pyramid [stem@R, s1@R/2, ...,
    s4@R/16] plus the raw input volume for the full-resolution skip.

    unet_encoders: [0] raw volume, [1] stem, [k + 2] stage k output;
    unet_decoders: [0] the patch-size upsample (by the patch of each axis),
    [i + 1] stage i upsample.

    Each block runs under the rematerialisation mode ``remat``
    (``layers.checkpoint_block``, the JAX decoder's ``remat_module``);
    ``"mixed"`` gives the two full-resolution blocks, ``unet_encoders[0]``
    and ``unet_decoders[0]`` (the JAX ``encoder0`` / ``decoder0``, whose
    kept conv outputs are the largest), ``"full"`` and the others
    ``"conv"``."""

    def __init__(self, in_chans: int, out_channels: int, hidden_size: int = 48,
                 patch_size: Tuple[int, int, int] = (2, 2, 2),
                 num_layers: int = 4, remat: str = "none"):
        super().__init__()
        self.remat = remat
        h = hidden_size
        self.unet_encoders = nn.ModuleList(
            [UnetrBasicBlock(in_chans, h), UnetrBasicBlock(h, h)]
            + [UnetrBasicBlock(h * 2 ** (i + 1), h * 2 ** (i + 1))
               for i in range(num_layers)])
        self.unet_decoders = nn.ModuleList(
            [UnetrUpBlock(h, h, tuple(patch_size))]
            + [UnetrUpBlock(h * 2 ** (i + 1), h * 2 ** i)
               for i in range(num_layers)])
        self.out = UnetOutBlock(h, out_channels)

    def decode(self, vol: torch.Tensor, z: List[torch.Tensor]) -> torch.Tensor:
        nl = len(self.unet_decoders) - 1
        mode = self.remat
        hires = "full" if mode == "mixed" else mode
        enc0 = checkpoint_block(self.unet_encoders[0], hires, vol)
        enc = [checkpoint_block(self.unet_encoders[k + 1], mode, z[k])
               for k in range(nl + 1)]
        x = enc[-1]
        for i in range(nl - 1, -1, -1):
            x = checkpoint_block(self.unet_decoders[i + 1], mode, x, enc[i])
        x = checkpoint_block(self.unet_decoders[0], hires, x, enc0)
        return self.out(x)


class SwinUNETRCustom(SwinUNETRDecoder):
    """An encoder that returns a 5-scale pyramid + the UNETR decoder: the
    flagship ``nnFormerUNETR`` (Swin encoder) and ``GCViTUNETR`` (GC-ViT,
    whose stem at R/2 plays the patch embedding's part).

    forward((vol (B, D, H, W, Cin), crop_loc (B, 3), affine (B, 3))) ->
    (B, D, H, W, n_classes) fp32 logits. The decoder's modules sit at the top
    level, beside ``encoder``, as in the reference state_dict."""

    def __init__(self, encoder: nn.Module, in_chans: int,
                 out_channels: int, hidden_size: int = 48,
                 patch_size: Tuple[int, int, int] = (2, 2, 2),
                 num_layers: int = 4, dtype: torch.dtype = torch.bfloat16,
                 remat: str = "none"):
        super().__init__(in_chans, out_channels, hidden_size, patch_size,
                         num_layers=num_layers, remat=remat)
        self.encoder = encoder
        self.dtype = dtype

    def forward(self, x_in: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                ) -> torch.Tensor:
        vol = x_in[0].to(self.dtype)
        return self.decode(vol, self.encoder(vol, *x_in[1:]))


class LinearEmbed(nn.Module):
    """Per-scale dense to the shared embedding width (the JAX
    ``_LinearEmbed``)."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Linear(in_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.proj)


class FuseConv(nn.Module):
    """1x1 conv + BatchNorm (eps 1e-3; batch statistics in training, running
    ones in eval) + exact GELU (the JAX ``_FuseConv``)."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.conv = Conv3d(in_dim, features, 1, bias=True)
        self.bn = BatchNorm(features, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.bn(self.conv(x)))


class SegFormerHead(nn.Module):
    """Progressive top-down all-MLP head over a 5-scale pyramid: embed the
    coarsest scale, resize it to the next finer one, fuse with that scale's
    embedding, and so on; the fused 512-channel map is resized to the input
    size and, in training, dropped out (rate 0.1) before the 1x1 classifier
    (``SwinSegFormer``)."""

    def __init__(self, encoder: nn.Module, in_dims: Sequence[int],
                 num_classes: int, embedding_dim: int = 512,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if len(in_dims) != 5:
            raise ValueError(f"SegFormerHead reads 5 scales, got {in_dims}")
        self.encoder = encoder
        self.dtype = dtype
        e = embedding_dim
        for k, dim in enumerate(in_dims):
            self.add_module(f"linear_c{k}", LinearEmbed(dim, e))
        for k in range(4):
            self.add_module(f"linear_fuse_{k}", FuseConv(2 * e, e))
        self.dropout = Dropout(0.1)  # JAX decoders.py:311
        self.linear_pred = Conv3d(e, num_classes, 1, bias=True)

    def forward(self, x_in: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                ) -> torch.Tensor:
        vol = x_in[0].to(self.dtype)
        z = self.encoder(vol, *x_in[1:])
        c = self.linear_c4(z[4])
        for k in (3, 2, 1, 0):
            c = resize_trilinear(c, z[k].shape[1:4])
            c = getattr(self, f"linear_fuse_{k}")(torch.cat(
                [c, getattr(self, f"linear_c{k}")(z[k])], dim=-1))
        c = resize_trilinear(c, vol.shape[1:4])
        return self.linear_pred(self.dropout(c)).float()


class SegFormerHeadOfficial(nn.Module):
    """Official SegFormer head over the last four scales: embed each, resize
    all to the finest of them, concatenate, fuse once, drop out (rate 0.1,
    in training), classify, and resize the logits to the input size
    (``SegFormer3D``)."""

    def __init__(self, encoder: nn.Module, in_dims: Sequence[int],
                 num_classes: int, embedding_dim: int = 512,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if len(in_dims) != 4:
            raise ValueError(f"SegFormerHeadOfficial reads 4 scales, got "
                             f"{in_dims}")
        self.encoder = encoder
        self.dtype = dtype
        e = embedding_dim
        for k, dim in enumerate(in_dims):
            self.add_module(f"linear_c{k + 1}", LinearEmbed(dim, e))
        self.linear_fuse = FuseConv(4 * e, e)
        self.dropout = Dropout(0.1)  # JAX decoders.py:342
        self.linear_pred = Conv3d(e, num_classes, 1, bias=True)

    def forward(self, x_in: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                ) -> torch.Tensor:
        vol = x_in[0].to(self.dtype)
        c1, c2, c3, c4 = self.encoder(vol)[-4:]
        target = c1.shape[1:4]
        parts = [resize_trilinear(self.linear_c4(c4), target),
                 resize_trilinear(self.linear_c3(c3), target),
                 resize_trilinear(self.linear_c2(c2), target),
                 self.linear_c1(c1)]
        out = self.linear_pred(self.dropout(
            self.linear_fuse(torch.cat(parts, dim=-1))))
        return resize_trilinear(out, vol.shape[1:4]).float()
