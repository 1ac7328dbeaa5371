"""Model factory (counterpart of medicalsemseg_tpu/models/factory.py).

Ported: the flagship ``nnFormerUNETR``, ``SwinSegFormer`` (the same Swin
encoder under the progressive SegFormer head), ``SegFormer3D`` (MixViT encoder
under the official SegFormer head) and ``GCViTUNETR`` (GC-ViT encoder under
the UNETR decoder). The other models of the zoo and the Swin encoder's
options beyond ``--qkv_bias`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from medicalsemseg_tpu_torch.config import Config
from medicalsemseg_tpu_torch.models.decoders import (
    LinearEmbed,
    SegFormerHead,
    SegFormerHeadOfficial,
    SwinUNETRCustom,
)
from medicalsemseg_tpu_torch.models.gcvit import SE, GCViT3D, GCWindowAttention
from medicalsemseg_tpu_torch.models.layers import Conv3d, ConvTranspose3d
from medicalsemseg_tpu_torch.models.segformer import MixVisionTransformer3D
from medicalsemseg_tpu_torch.models.swin import SwinEncoder3D, WindowAttention

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}

MODEL_NAMES = ("nnFormerUNETR", "SwinSegFormer", "SegFormer3D", "GCViTUNETR")

# options of the Swin encoder that the port does not take yet, by the models
# whose JAX factory branch reads them
_UNPORTED_FLAGS = {
    "nnFormerUNETR": ("learned_cls_vectors", "rel_crop_pos_emb",
                      "rel_pos_bias_affine", "abs_pos_emb", "global_token"),
    "SwinSegFormer": ("abs_pos_emb",),
}


def build_model(cfg: Config) -> nn.Module:
    """--model name -> the encoder + decoder pair, parameters uninitialised
    (fill them with :func:`init_weights` or a state_dict). Input: (volume
    (B, D, H, W, Cin), crop_loc (B, 3), affine (B, 3)); output: (B, D, H, W,
    n_classes) fp32 logits."""
    name = cfg.model
    if name not in MODEL_NAMES:
        raise NotImplementedError(
            f"--model {name} is not ported yet (ROADMAP queue 1 item 13, "
            f"the rest of the model zoo); the port has {', '.join(MODEL_NAMES)}")
    on = [f for f in _UNPORTED_FLAGS.get(name, ()) if getattr(cfg, f)]
    if on:
        raise NotImplementedError(
            f"encoder options {on} are not ported yet (ROADMAP queue 1 item "
            "13, the rest of the model zoo)")
    dtype = DTYPES[cfg.compute_dtype]
    patch = cfg.patch_size3()
    dims = [cfg.hidden_dim * 2 ** i for i in range(len(cfg.depths) + 1)]

    if name in ("nnFormerUNETR", "SwinSegFormer"):
        # SwinSegFormer's encoder is built without --mlp_ratio (the
        # encoder's own 4.0), as the JAX factory builds it
        encoder = SwinEncoder3D(
            img_size=cfg.vol_size3(), patch_size=patch, in_chans=cfg.in_chans,
            embed_dim=cfg.hidden_dim, depths=tuple(cfg.depths),
            num_heads=tuple(cfg.num_heads), window_sizes=cfg.window_sizes(),
            mlp_ratio=cfg.mlp_ratio if name == "nnFormerUNETR" else 4.0,
            qkv_bias=cfg.qkv_bias, drop_path_rate=cfg.drop_path_rate)
        if name == "SwinSegFormer":
            return SegFormerHead(encoder, dims, cfg.output_dim, dtype=dtype)
    elif name == "SegFormer3D":
        encoder = MixVisionTransformer3D(
            in_chans=cfg.in_chans, embed_dim=cfg.hidden_dim,
            depths=tuple(cfg.depths), num_heads=tuple(cfg.num_heads),
            sr_ratios=(8, 4, 2, 1), qkv_bias=cfg.qkv_bias,
            drop_path_rate=cfg.drop_path_rate)
        return SegFormerHeadOfficial(encoder, dims[:len(cfg.depths)],
                                     cfg.output_dim, dtype=dtype)
    else:
        encoder = GCViT3D(
            img_size=cfg.vol_size3(), in_chans=cfg.in_chans,
            dim=cfg.hidden_dim, depths=tuple(cfg.depths),
            num_heads=tuple(cfg.num_heads), window_sizes=cfg.window_sizes(),
            mlp_ratio=3.0, qkv_bias=cfg.qkv_bias,
            ref_quirk_index=cfg.ref_quirk_rel_pos,
            drop_path_rate=cfg.drop_path_rate)
    return SwinUNETRCustom(encoder, cfg.in_chans, cfg.output_dim,
                           hidden_size=cfg.hidden_dim, patch_size=patch[0],
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
    ``nn.Dense`` without a ``kernel_init``."""
    if isinstance(parent, SE):
        return [parent.fc1, parent.fc2]
    if isinstance(parent, LinearEmbed):
        return [parent.proj]
    return []


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX model's initialisers, drawn from ``generator``: truncated
    normal(0.02) for the dense weights the JAX modules name it for (attention,
    MLPs) and for bias tables, lecun normal for conv kernels and for the
    dense layers left at flax's default (the SE gates, the SegFormer heads'
    per-scale embeddings), zeros for biases, ones/zeros for norms and running
    statistics (set at construction)."""
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
            elif isinstance(m, (Conv3d, ConvTranspose3d)):
                _lecun_normal_(m.weight, _conv_fan_in(
                    m.weight, transposed=isinstance(m, ConvTranspose3d)),
                    generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (WindowAttention, GCWindowAttention)):
                _trunc_normal_(m.relative_position_bias_table, 0.02, generator)
    return model
