"""Parameter conversion between the JAX flagship and the port, and torch
checkpoints.

:func:`state_dict_from_jax` is the inverse of
``medicalsemseg_tpu/utils/torch_import.py:import_swin_unetr_checkpoint``:
it turns the JAX flagship's parameter tree (nested dicts of numpy arrays)
into the port's state_dict, which is also the reference PyTorch layout:

  Dense kernel (I, O)                  -> Linear weight (O, I)
  Conv kernel (k, k, k, I, O)          -> Conv3d weight (O, I, k, k, k)
  ConvTranspose kernel (k, k, k, I, O) -> un-flipped, (I, O, k, k, k)
  LayerNorm_0 scale / bias             -> weight / bias
  InstanceNorm scale / bias            -> weight / bias

It takes numpy and imports no jax.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _dense(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv_transpose(sd, prefix, p):
    k = np.asarray(p["kernel"])[::-1, ::-1, ::-1]  # undo the spatial flip
    sd[f"{prefix}.weight"] = _t(k.transpose(3, 4, 0, 1, 2))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm(sd, prefix, p):
    """LayerNorm wrapper ({'LayerNorm_0': {scale, bias}}) or InstanceNorm
    ({scale, bias})."""
    p = p.get("LayerNorm_0", p)
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _res_block(sd, prefix, p):
    for k in ("1", "2", "3"):
        if f"conv{k}" in p:
            _conv(sd, f"{prefix}.conv{k}.conv", p[f"conv{k}"]["Conv_0"])
            _norm(sd, f"{prefix}.norm{k}", p[f"norm{k}"])


def state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX flagship tree {'encoder': ..., 'decoder': ...} -> port state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    enc = params["encoder"]
    _conv(sd, "encoder.patch_embed.proj", enc["patch_embed"]["Conv_0"])
    _norm(sd, "encoder.patch_embed.norm", enc["patch_embed"]["LayerNorm_0"])
    i = 0
    while f"layers_{i}" in enc:
        layer = enc[f"layers_{i}"]
        j = 0
        while f"blocks_{j}" in layer:
            blk, base = layer[f"blocks_{j}"], f"encoder.layers.{i}.blocks.{j}"
            _norm(sd, f"{base}.norm1", blk["LayerNorm_0"])
            _norm(sd, f"{base}.norm2", blk["LayerNorm_1"])
            attn = blk["attn"]
            qkv = {"kernel": attn["qkv_kernel"]}
            if "qkv_bias" in attn:
                qkv["bias"] = attn["qkv_bias"]
            _dense(sd, f"{base}.attn.qkv", qkv)
            _dense(sd, f"{base}.attn.proj", {"kernel": attn["proj_kernel"],
                                              "bias": attn["proj_bias"]})
            sd[f"{base}.attn.relative_position_bias_table"] = _t(
                attn["relative_position_bias_table"])
            _dense(sd, f"{base}.mlp.fc1", blk["Mlp_0"]["Dense_0"])
            _dense(sd, f"{base}.mlp.fc2", blk["Mlp_0"]["Dense_1"])
            j += 1
        down = layer["downsample"]
        _norm(sd, f"encoder.layers.{i}.downsample.norm", down["LayerNorm_0"])
        _conv(sd, f"encoder.layers.{i}.downsample.reduction",
              down["reduction"]["Conv_0"])
        _norm(sd, f"encoder.norm{i}", enc[f"norm{i}"])
        i += 1

    dec = params["decoder"]
    k = 0
    while f"encoder{k}" in dec:
        _res_block(sd, f"unet_encoders.{k}.layer", dec[f"encoder{k}"])
        k += 1
    k = 0
    while f"decoder{k}" in dec:
        d = dec[f"decoder{k}"]
        _conv_transpose(sd, f"unet_decoders.{k}.transp_conv.conv",
                        d["transp_conv"]["ConvTranspose_0"])
        _res_block(sd, f"unet_decoders.{k}.conv_block", d["conv_block"])
        k += 1
    _conv(sd, "out.conv.conv", dec["out"]["conv"]["Conv_0"])
    return sd


def strip_module_prefix(sd: Dict) -> Dict:
    """Drop the 'module.' prefix that DistributedDataParallel adds."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file holding ``{'model': state_dict, ...}`` (the
    reference's layout) or a bare state_dict -> the model state_dict.
    Loaded with ``weights_only=True``: tensors and plain containers only."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and isinstance(payload.get("model"), dict):
        payload = payload["model"]
    return strip_module_prefix(payload)
