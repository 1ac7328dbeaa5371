"""UNETR: the ViT encoder under a progressive-upsampling convolutional
decoder (counterpart of medicalsemseg_tpu/models/unetr.py), the model of
``UNETR_Official``.

Feature size F, ViT width H, patch 16: ``encoder1`` is a res block on the
raw volume (F); the taps z3, z6, z9 go through progressive up-blocks to 2F
at 1/4 (two stages of transposed conv + res block), 4F at 1/8 (one) and 8F
at 1/16 (the first transposed conv alone); the decoder chain upsamples from
the final tap with a skip and a res block at each scale, then a 1x1 conv to
fp32 logits. The decoder's res blocks never take the fused form of
``MEDSEG_FUSED_DECODER``: the JAX module passes no ``fuse`` to them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from medicalsemseg_tpu_torch.models.decoders import (
    Convolution,
    UnetOutBlock,
    UnetResBlock,
    UnetrUpBlock,
)
from medicalsemseg_tpu_torch.models.layers import ConvTranspose3d
from medicalsemseg_tpu_torch.models.vit import ViT3D

Tuple3 = Tuple[int, int, int]


class UnetrPrUpBlock(nn.Module):
    """A 2x transposed conv (``transp_conv_init``), then ``num_layer``
    times a 2x transposed conv (``up.{i}``) and a res block (``res.{i}``)."""

    def __init__(self, in_ch: int, out_ch: int, num_layer: int):
        super().__init__()
        self.transp_conv_init = Convolution(ConvTranspose3d(in_ch, out_ch, 2))
        self.up = nn.ModuleList([Convolution(ConvTranspose3d(out_ch, out_ch,
                                                             2))
                                 for _ in range(num_layer)])
        self.res = nn.ModuleList([UnetResBlock(out_ch, out_ch, fusable=False)
                                  for _ in range(num_layer)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transp_conv_init(x)
        for up, res in zip(self.up, self.res):
            x = res(up(x))
        return x


class UNETR(nn.Module):
    """forward((vol (B, D, H, W, Cin), crop_loc, affine)) -> (B, D, H, W,
    n_classes) fp32 logits; ``img_size`` ties the ViT's position table."""

    def __init__(self, img_size: Tuple3, out_channels: int, in_chans: int = 1,
                 feature_size: int = 16, hidden_size: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 patch_size: Tuple3 = (16, 16, 16), qkv_bias: bool = True,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        f, h = feature_size, hidden_size
        self.dtype = dtype
        self.vit = ViT3D(img_size, patch_size, in_chans, h, depth, num_heads,
                         mlp_ratio, qkv_bias, drop_path_rate,
                         out_indices=(depth // 4, depth // 2, 3 * depth // 4,
                                      depth))
        self.encoder1 = UnetResBlock(in_chans, f, fusable=False)
        self.encoder2 = UnetrPrUpBlock(h, 2 * f, 2)
        self.encoder3 = UnetrPrUpBlock(h, 4 * f, 1)
        self.encoder4 = UnetrPrUpBlock(h, 8 * f, 0)
        self.decoder5 = UnetrUpBlock(h, 8 * f, fusable=False)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f, fusable=False)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f, fusable=False)
        self.decoder2 = UnetrUpBlock(2 * f, f, fusable=False)
        self.out = UnetOutBlock(f, out_channels)

    def forward(self, x_in) -> torch.Tensor:
        vol = x_in[0].to(self.dtype)
        z3, z6, z9, z12 = self.vit(vol)
        enc1 = self.encoder1(vol)
        enc2 = self.encoder2(z3)
        enc3 = self.encoder3(z6)
        enc4 = self.encoder4(z9)
        x = self.decoder5(z12, enc4)
        x = self.decoder4(x, enc3)
        x = self.decoder3(x, enc2)
        x = self.decoder2(x, enc1)
        return self.out(x)
