"""Model factory (counterpart of medicalsemseg_tpu/models/factory.py).

Only the flagship ``nnFormerUNETR`` is ported; the other models of the zoo
and the encoder options beyond ``--qkv_bias`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from medicalsemseg_tpu_torch.config import Config
from medicalsemseg_tpu_torch.models.decoders import SwinUNETRCustom
from medicalsemseg_tpu_torch.models.layers import Conv3d, ConvTranspose3d
from medicalsemseg_tpu_torch.models.swin import SwinEncoder3D, WindowAttention

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}

# encoder options of the JAX factory that the port does not take yet
_UNPORTED_FLAGS = ("learned_cls_vectors", "rel_crop_pos_emb",
                   "rel_pos_bias_affine", "abs_pos_emb", "global_token")


def build_model(cfg: Config) -> SwinUNETRCustom:
    """--model nnFormerUNETR -> the encoder + UNETR decoder, parameters
    uninitialised (fill them with :func:`init_weights` or a state_dict)."""
    if cfg.model != "nnFormerUNETR":
        raise NotImplementedError(
            f"--model {cfg.model} is not ported yet (ROADMAP queue 1 item 13, "
            "the rest of the model zoo); the port has nnFormerUNETR")
    on = [f for f in _UNPORTED_FLAGS if getattr(cfg, f)]
    if on:
        raise NotImplementedError(
            f"encoder options {on} are not ported yet (ROADMAP queue 1 item "
            "13, the rest of the model zoo)")
    patch = cfg.patch_size3()
    encoder = SwinEncoder3D(
        img_size=cfg.vol_size3(), patch_size=patch, in_chans=cfg.in_chans,
        embed_dim=cfg.hidden_dim, depths=tuple(cfg.depths),
        num_heads=tuple(cfg.num_heads), window_sizes=cfg.window_sizes(),
        mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
        drop_path_rate=cfg.drop_path_rate)
    return SwinUNETRCustom(encoder, cfg.in_chans, cfg.output_dim,
                           hidden_size=cfg.hidden_dim, patch_size=patch[0],
                           dtype=DTYPES[cfg.compute_dtype])


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


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX model's initialisers, drawn from ``generator``: truncated
    normal(0.02) for dense weights and bias tables, lecun normal for conv
    kernels, zeros for biases, ones/zeros for norms (set at construction)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                _trunc_normal_(m.weight, 0.02, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (Conv3d, ConvTranspose3d)):
                _lecun_normal_(m.weight, _conv_fan_in(
                    m.weight, transposed=isinstance(m, ConvTranspose3d)),
                    generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, WindowAttention):
                _trunc_normal_(m.relative_position_bias_table, 0.02, generator)
    return model
