"""Model factory (counterpart of medicalsemseg_tpu/models/factory.py).

Every model of the JAX factory: the flagship ``nnFormerUNETR``,
``SwInception`` and ``SwinDepth`` (the same Swin encoder with the inception
or depthwise-conv token MLP, every one of the three with all the Swin
encoder's options, under the UNETR decoder), ``SwinSegFormer`` (the Swin
encoder under the progressive SegFormer head), ``SegFormer3D`` (MixViT
encoder under the official SegFormer head), ``GCViTUNETR`` (GC-ViT encoder
under the UNETR decoder), ``FocalNetUNETR`` (FocalNet under the UNETR
decoder), ``UNETR_Official`` (a ViT-B UNETR), the official ``nnFormer``
(symmetric, with cross-attention skips and deep supervision),
``SwinUNETR_Official`` (MONAI's SwinUNETR), ``LRGFormerUNETR`` (the
local / region / global encoder under the UNETR decoder),
``VideoSwinUNETR`` (Video-Swin on MONAI's blocks under the UNETR decoder)
and ``Swin2D`` (the 2D Swin pyramid under a linear-fuse head; ``--input_dim
2``).
"""

from __future__ import annotations

import functools
import os

import torch
import torch.nn as nn

from medicalsemseg_tpu_torch.config import Config
from medicalsemseg_tpu_torch.models.decoders import (
    LinearEmbed,
    SegFormerHead,
    SegFormerHeadOfficial,
    SwinUNETRCustom,
)
from medicalsemseg_tpu_torch.models.embeddings import (
    LearnedClassVectors,
    scale_intensity_range,
    scale_intensity_range_percentiles,
)
from medicalsemseg_tpu_torch.models.focalnet import FocalNet3D
from medicalsemseg_tpu_torch.models.gcvit import SE, GCViT3D, GCWindowAttention
from medicalsemseg_tpu_torch.models.layers import Conv3d, ConvTranspose3d
from medicalsemseg_tpu_torch.models.lrgformer import LRGFormer3D
from medicalsemseg_tpu_torch.models.nnformer import (
    CrossWindowAttention,
    NNFormer,
)
from medicalsemseg_tpu_torch.models.segformer import MixVisionTransformer3D
from medicalsemseg_tpu_torch.models.swin import (
    SwinEncoder3D,
    WindowAttention,
)
from medicalsemseg_tpu_torch.models.swin2d import (
    Swin2DSeg,
    SwinTransformer2D,
    WindowAttention2D,
)
from medicalsemseg_tpu_torch.models.swin_official import (
    OfficialPatchMerging,
    OfficialWindowAttention,
    SwinUNETROfficial,
)
from medicalsemseg_tpu_torch.models.unetr import UNETR
from medicalsemseg_tpu_torch.models.video_swin import (
    VideoPatchMerging,
    VideoSwin3D,
)
from medicalsemseg_tpu_torch.models.vit import ViT3D

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}

# the Swin-encoder models under the UNETR decoder, by their token MLP
SWIN_UNETR_MLPS = {"nnFormerUNETR": "dense", "SwInception": "inception",
                   "SwinDepth": "dwconv"}
# the JAX factory's names, in its order
MODEL_NAMES = (
    "nnFormerUNETR", "SwInception", "SwinDepth", "SwinSegFormer",
    "SegFormer3D", "GCViTUNETR", "FocalNetUNETR", "UNETR_Official",
    "nnFormer", "SwinUNETR_Official", "LRGFormerUNETR", "VideoSwinUNETR",
    "Swin2D",
)


def official_fused_enabled() -> bool:
    """``MEDSEG_OFFICIAL_FUSED=1``: SwinUNETR_Official's blocks run K1 (its
    7^3 windows on the CUDA-core route) and K2 in eval mode. Off by
    default, as in the JAX factory, so both packages take the same route."""
    return os.environ.get("MEDSEG_OFFICIAL_FUSED", "0") == "1"


def _lcv_transform(cfg: Config):
    """The intensity transform of the class vectors' HU interval table:
    the fixed CT window [t_ct_min, t_ct_max] to [0, 1] under
    ``--t_fixed_ct_intensity``, else the table's own 5th / 95th
    percentiles to [0, 1]; clipped either way."""
    if cfg.t_fixed_ct_intensity:
        return functools.partial(scale_intensity_range, a_min=cfg.t_ct_min,
                                 a_max=cfg.t_ct_max, b_min=0.0, b_max=1.0,
                                 clip=True)
    return functools.partial(scale_intensity_range_percentiles, lower=5,
                             upper=95, b_min=0.0, b_max=1.0, clip=True)


def _swin_encoder(cfg: Config, mlp_type: str) -> SwinEncoder3D:
    """The Swin encoder of the UNETR models with every option the JAX
    factory branch reads."""
    return SwinEncoder3D(
        img_size=cfg.vol_size3(), patch_size=cfg.patch_size3(),
        in_chans=cfg.in_chans, embed_dim=cfg.hidden_dim,
        depths=tuple(cfg.depths), num_heads=tuple(cfg.num_heads),
        window_sizes=cfg.window_sizes(), mlp_ratio=cfg.mlp_ratio,
        qkv_bias=cfg.qkv_bias, drop_path_rate=cfg.drop_path_rate,
        mlp_type=mlp_type, learned_cls_vectors=cfg.learned_cls_vectors,
        lcv_transform=(_lcv_transform(cfg) if cfg.learned_cls_vectors
                       else None),
        lcv_vector_dim=cfg.lcv_vector_dim, lcv_sincos_emb=cfg.lcv_sincos_emb,
        lcv_final_layer=cfg.lcv_final_layer,
        lcv_concat_vector=cfg.lcv_concat_vector, lcv_only=cfg.lcv_only,
        lcv_linear_comb=cfg.lcv_linear_comb,
        lcv_patch_voxel_mean=cfg.lcv_patch_voxel_mean,
        rel_crop_pos_emb=cfg.rel_crop_pos_emb,
        rel_pos_bias_affine=cfg.rel_pos_bias_affine,
        abs_pos_emb=cfg.abs_pos_emb, global_token=cfg.global_token)


def build_model(cfg: Config) -> nn.Module:
    """--model name -> the encoder + decoder pair, parameters uninitialised
    (fill them with :func:`init_weights` or a state_dict). Input: (volume
    (B, D, H, W, Cin), crop_loc (B, 3), affine (B, 3)); output: (B, D, H, W,
    n_classes) fp32 logits."""
    name = cfg.model
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{', '.join(MODEL_NAMES)}")
    dtype = DTYPES[cfg.compute_dtype]
    patch = cfg.patch_size3()
    dims = [cfg.hidden_dim * 2 ** i for i in range(len(cfg.depths) + 1)]

    if name in SWIN_UNETR_MLPS:
        encoder = _swin_encoder(cfg, SWIN_UNETR_MLPS[name])
    elif name == "SwinSegFormer":
        # built without the LCV / crop / affine / global-token options and
        # without --mlp_ratio (the encoder's own 4.0), as the JAX factory
        # builds it
        encoder = SwinEncoder3D(
            img_size=cfg.vol_size3(), patch_size=patch, in_chans=cfg.in_chans,
            embed_dim=cfg.hidden_dim, depths=tuple(cfg.depths),
            num_heads=tuple(cfg.num_heads), window_sizes=cfg.window_sizes(),
            qkv_bias=cfg.qkv_bias, drop_path_rate=cfg.drop_path_rate,
            abs_pos_emb=cfg.abs_pos_emb)
        return SegFormerHead(encoder, dims, cfg.output_dim, dtype=dtype)
    elif name == "SegFormer3D":
        encoder = MixVisionTransformer3D(
            in_chans=cfg.in_chans, embed_dim=cfg.hidden_dim,
            depths=tuple(cfg.depths), num_heads=tuple(cfg.num_heads),
            sr_ratios=(8, 4, 2, 1), qkv_bias=cfg.qkv_bias,
            drop_path_rate=cfg.drop_path_rate)
        return SegFormerHeadOfficial(encoder, dims[:len(cfg.depths)],
                                     cfg.output_dim, dtype=dtype)
    elif name == "nnFormer":
        return NNFormer(
            cfg.vol_size3(), cfg.output_dim, in_chans=cfg.in_chans,
            embed_dim=cfg.hidden_dim, depths=tuple(cfg.depths),
            num_heads=tuple(cfg.num_heads), window_sizes=cfg.window_sizes(),
            patch_size=patch, qkv_bias=cfg.qkv_bias,
            drop_path_rate=cfg.drop_path_rate,
            deep_supervision=cfg.deep_supervision,
            ref_quirk_index=cfg.ref_quirk_rel_pos, dtype=dtype)
    elif name == "SwinUNETR_Official":
        # MONAI's fixed 7^3 window, patch 2, qkv bias and MLP ratio 4, as
        # the JAX factory builds it
        return SwinUNETROfficial(
            cfg.output_dim, in_chans=cfg.in_chans,
            feature_size=cfg.hidden_dim, depths=tuple(cfg.depths),
            num_heads=tuple(cfg.num_heads),
            drop_path_rate=cfg.drop_path_rate,
            fused=official_fused_enabled(), dtype=dtype)
    elif name == "FocalNetUNETR":
        encoder = FocalNet3D(
            patch_size=patch, in_chans=cfg.in_chans, embed_dim=cfg.hidden_dim,
            depths=tuple(cfg.depths), focal_windows=cfg.window_sizes(),
            drop_path_rate=cfg.drop_path_rate)
    elif name == "UNETR_Official":
        # ViT-B (width 768, 12 blocks of 12 heads, patch 16) whatever the
        # flags, the feature size from --hidden_dim, as the JAX factory
        # builds it
        return UNETR(cfg.vol_size3(), cfg.output_dim, in_chans=cfg.in_chans,
                     feature_size=max(cfg.hidden_dim // 3, 8),
                     hidden_size=768, depth=12, num_heads=12,
                     patch_size=(16, 16, 16),
                     drop_path_rate=cfg.drop_path_rate, dtype=dtype)
    elif name == "LRGFormerUNETR":
        # local tokens at twice the patch (the reference's token budget)
        patch = tuple(2 * p for p in patch)
        encoder = LRGFormer3D(
            cfg.vol_size3(), patch_size=patch, in_chans=cfg.in_chans,
            embed_dim=cfg.hidden_dim, depths=tuple(cfg.depths),
            num_heads=tuple(cfg.num_heads), mlp_ratio=cfg.mlp_ratio,
            qkv_bias=cfg.qkv_bias, drop_path_rate=cfg.drop_path_rate)
    elif name == "Swin2D":
        if cfg.input_dim != 2:
            raise ValueError("--model Swin2D requires --input_dim 2")
        return Swin2DSeg(
            cfg.vol_size3()[0], cfg.output_dim, in_chans=cfg.in_chans,
            embed_dim=cfg.hidden_dim, depths=tuple(cfg.depths),
            num_heads=tuple(cfg.num_heads),
            window_size=cfg.window_sizes()[0],
            patch_size=patch[0] if patch[0] > 1 else 4,
            mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
            drop_path_rate=cfg.drop_path_rate, dtype=dtype)
    elif name == "VideoSwinUNETR":
        w = cfg.window_sizes()[0]
        encoder = VideoSwin3D(
            cfg.vol_size3(), in_chans=cfg.in_chans, embed_dim=cfg.hidden_dim,
            depths=tuple(cfg.depths), num_heads=tuple(cfg.num_heads),
            window=(w, w, w), patch_size=patch, mlp_ratio=cfg.mlp_ratio,
            qkv_bias=cfg.qkv_bias, drop_path_rate=cfg.drop_path_rate,
            ape=cfg.abs_pos_emb)
    else:
        if patch != (2, 2, 2):
            # GC-ViT's stem halves every axis; the JAX decoder's first
            # up-block upsamples by the patch, so another patch cannot meet
            # the full-resolution skip there either
            raise ValueError(f"GCViTUNETR needs --patch_size 2 (its stem "
                             f"halves every axis), got {patch}")
        encoder = GCViT3D(
            img_size=cfg.vol_size3(), in_chans=cfg.in_chans,
            dim=cfg.hidden_dim, depths=tuple(cfg.depths),
            num_heads=tuple(cfg.num_heads), window_sizes=cfg.window_sizes(),
            mlp_ratio=3.0, qkv_bias=cfg.qkv_bias,
            ref_quirk_index=cfg.ref_quirk_rel_pos,
            drop_path_rate=cfg.drop_path_rate)
    return SwinUNETRCustom(encoder, cfg.in_chans, cfg.output_dim,
                           hidden_size=cfg.hidden_dim, patch_size=patch,
                           num_layers=len(cfg.depths), dtype=dtype)


def _trunc_normal_(t: torch.Tensor, std: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated to +-2 std (flax's truncated_normal init)."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal: truncated normal with variance 1 / fan_in."""
    # flax divides by the std of a unit normal truncated to +-2 (0.8796)
    return _trunc_normal_(t, (1.0 / fan_in) ** 0.5 / 0.87962566103423978,
                         generator)


def _conv_fan_in(weight: torch.Tensor, transposed: bool = False) -> int:
    k = weight[0, 0].numel()
    return k * (weight.shape[0] if transposed else weight.shape[1])


def _default_init_dense(parent: nn.Module):
    """The ``nn.Linear`` children of ``parent`` whose JAX counterpart is an
    ``nn.Dense`` (or raw dense leaves) with flax's default ``kernel_init``,
    lecun normal."""
    if isinstance(parent, SE):
        return [parent.fc1, parent.fc2]
    if isinstance(parent, LinearEmbed):
        return [parent.proj]
    if isinstance(parent, OfficialWindowAttention):
        return [parent.qkv, parent.proj]
    if isinstance(parent, (OfficialPatchMerging, VideoPatchMerging)):
        return [parent.reduction]
    return []


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX model's initialisers, drawn from ``generator``: truncated
    normal(0.02) for the dense weights the JAX modules name it for (attention,
    MLPs, the encoder options' dense layers), for bias tables and for the
    global token, normal(1.0) for the learned class vectors, lecun normal
    for conv kernels and for the dense layers left at flax's default (the SE
    gates, the SegFormer heads' per-scale embeddings), zeros for biases,
    ones/zeros for norms and running statistics (set at construction)."""
    lecun_dense = {m for parent in model.modules()
                   for m in _default_init_dense(parent)}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                if m in lecun_dense:
                    _lecun_normal_(m.weight, m.weight.shape[1], generator)
                else:
                    _trunc_normal_(m.weight, 0.02, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (Conv3d, ConvTranspose3d, nn.Conv2d)):
                _lecun_normal_(m.weight, _conv_fan_in(
                    m.weight, transposed=isinstance(m, ConvTranspose3d)),
                    generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (WindowAttention, GCWindowAttention,
                                CrossWindowAttention,
                                OfficialWindowAttention, WindowAttention2D)):
                _trunc_normal_(m.relative_position_bias_table, 0.02, generator)
                if getattr(m, "rel_pos_bias_affine", False):
                    _trunc_normal_(m.rel_pos_bias_affine_emb, 0.02, generator)
            elif (isinstance(m, LearnedClassVectors)
                  and isinstance(m.vectors, nn.Parameter)):
                m.vectors.normal_(0.0, 1.0, generator=generator)
            elif isinstance(m, SwinEncoder3D) and hasattr(m, "global_token"):
                _trunc_normal_(m.global_token, 0.02, generator)
            elif isinstance(m, VideoSwin3D) and hasattr(
                    m, "absolute_pos_embed"):
                _trunc_normal_(m.absolute_pos_embed, 0.02, generator)
            elif (isinstance(m, SwinTransformer2D)
                  and m.absolute_pos_embed is not None):
                _trunc_normal_(m.absolute_pos_embed, 0.02, generator)
            elif isinstance(m, ViT3D):
                _trunc_normal_(m.pos_embed, 0.02, generator)
                if m.cls_token is not None:
                    _trunc_normal_(m.cls_token, 0.02, generator)
    return model
