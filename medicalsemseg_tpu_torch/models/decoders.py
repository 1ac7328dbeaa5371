"""UNETR-style decoder and the encoder + decoder model (counterpart of
medicalsemseg_tpu/models/decoders.py: UnetResBlock, UnetrUpBlock,
UnetOutBlock, SwinUNETRDecoder, SwinUNETRCustom).

Module names follow MONAI's blocks as the reference model nests them
(``unet_encoders.{k}.layer.conv1.conv``, ``unet_decoders.{k}.transp_conv.conv``,
``out.conv.conv``), so a reference state_dict loads as it is. The 3^3 convs,
InstanceNorm and the transposed convs are plain PyTorch (cuDNN on the card),
as the JAX package leaves them to XLA by default.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from medicalsemseg_tpu_torch.models.layers import (
    Conv3d,
    ConvTranspose3d,
    InstanceNorm,
    leaky_relu,
)
from medicalsemseg_tpu_torch.models.swin import SwinEncoder3D


class Convolution(nn.Module):
    """MONAI ``Convolution`` holder: the conv lives at ``.conv``."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UnetResBlock(nn.Module):
    """conv3-IN-lrelu -> conv3-IN, plus a 1x1-IN shortcut when the channel
    count changes, then lrelu."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = Convolution(Conv3d(in_ch, out_ch, 3, bias=False))
        self.norm1 = InstanceNorm(out_ch)
        self.conv2 = Convolution(Conv3d(out_ch, out_ch, 3, bias=False))
        self.norm2 = InstanceNorm(out_ch)
        if in_ch != out_ch:
            self.conv3 = Convolution(Conv3d(in_ch, out_ch, 1, bias=False))
            self.norm3 = InstanceNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = leaky_relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        res = self.norm3(self.conv3(x)) if hasattr(self, "conv3") else x
        return leaky_relu(y + res)


class UnetrBasicBlock(nn.Module):
    """MONAI ``UnetrBasicBlock(res_block=True)``: the block at ``.layer``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.layer = UnetResBlock(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """Transposed-conv upsample (kernel == stride), concat skip, res block."""

    def __init__(self, in_ch: int, out_ch: int, upsample: int = 2):
        super().__init__()
        self.transp_conv = Convolution(ConvTranspose3d(in_ch, out_ch, upsample))
        self.conv_block = UnetResBlock(2 * out_ch, out_ch)

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
    unet_decoders: [0] the patch-size upsample, [i + 1] stage i upsample."""

    def __init__(self, in_chans: int, out_channels: int, hidden_size: int = 48,
                 patch_size: int = 2, num_layers: int = 4):
        super().__init__()
        h = hidden_size
        self.unet_encoders = nn.ModuleList(
            [UnetrBasicBlock(in_chans, h), UnetrBasicBlock(h, h)]
            + [UnetrBasicBlock(h * 2 ** (i + 1), h * 2 ** (i + 1))
               for i in range(num_layers)])
        self.unet_decoders = nn.ModuleList(
            [UnetrUpBlock(h, h, patch_size)]
            + [UnetrUpBlock(h * 2 ** (i + 1), h * 2 ** i)
               for i in range(num_layers)])
        self.out = UnetOutBlock(h, out_channels)

    def decode(self, vol: torch.Tensor, z: List[torch.Tensor]) -> torch.Tensor:
        nl = len(self.unet_decoders) - 1
        enc0 = self.unet_encoders[0](vol)
        enc = [self.unet_encoders[k + 1](z[k]) for k in range(nl + 1)]
        x = enc[-1]
        for i in range(nl - 1, -1, -1):
            x = self.unet_decoders[i + 1](x, enc[i])
        x = self.unet_decoders[0](x, enc0)
        return self.out(x)


class SwinUNETRCustom(SwinUNETRDecoder):
    """Swin encoder + UNETR decoder, the flagship ``nnFormerUNETR``.

    forward((vol (B, D, H, W, Cin), crop_loc (B, 3), affine (B, 3))) ->
    (B, D, H, W, n_classes) fp32 logits. The decoder's modules sit at the top
    level, beside ``encoder``, as in the reference state_dict."""

    def __init__(self, encoder: SwinEncoder3D, in_chans: int,
                 out_channels: int, hidden_size: int = 48,
                 patch_size: int = 2, dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_chans, out_channels, hidden_size, patch_size,
                         num_layers=len(encoder.layers))
        self.encoder = encoder
        self.dtype = dtype

    def forward(self, x_in: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                ) -> torch.Tensor:
        vol = x_in[0].to(self.dtype)
        return self.decode(vol, self.encoder(vol))
