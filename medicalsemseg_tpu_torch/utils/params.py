"""Parameter conversion between the JAX flagship and the port, and torch
checkpoints.

One key map (:func:`key_map`) pairs every leaf of the JAX flagship's
parameter tree (nested dicts of arrays) with its key in the port's
state_dict, which is also the reference PyTorch layout, and names the layout
change between them:

  dense   Dense kernel (I, O)                  <-> Linear weight (O, I)
  conv    Conv kernel (k, k, k, I, O)          <-> Conv3d weight (O, I, k, k, k)
  convT   ConvTranspose kernel (k, k, k, I, O) <-> un-flipped, (I, O, k, k, k)
  plain   norm scale / bias, biases, tables    <-> weight / bias, unchanged

:func:`state_dict_from_jax` (the inverse of
``medicalsemseg_tpu/utils/torch_import.py:import_swin_unetr_checkpoint``)
and :func:`jax_tree_from_state_dict` walk it in the two directions. Every
change is a permutation of a leaf's elements, so the same functions carry
gradients and optimizer moments as well as weights.
:func:`load_adamw_state_from_optax` fills ``torch.optim.AdamW``'s state from
optax's (mu, nu, count). All take numpy and import no jax.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

KeyMap = List[Tuple[Tuple[str, ...], str, str]]

_TO_PORT = {
    "dense": lambda a: a.T,
    "conv": lambda a: a.transpose(4, 3, 0, 1, 2),
    "convT": lambda a: a[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2),
    "plain": lambda a: a,
}
_TO_JAX = {
    "dense": lambda a: a.T,
    "conv": lambda a: a.transpose(2, 3, 4, 1, 0),
    "convT": lambda a: a.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1],
    "plain": lambda a: a,
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def key_map(params: Dict) -> KeyMap:
    """(path in the JAX tree, state_dict key, layout change) for every leaf
    of the flagship tree {'encoder': ..., 'decoder': ...}."""
    out: KeyMap = []

    def kernel(path, prefix, p, kind):
        out.append((path + ("kernel",), f"{prefix}.weight", kind))
        if "bias" in p:
            out.append((path + ("bias",), f"{prefix}.bias", "plain"))

    def norm(path, prefix, p):
        # LayerNorm wrapper ({'LayerNorm_0': {scale, bias}}) or InstanceNorm
        if "LayerNorm_0" in p:
            path = path + ("LayerNorm_0",)
        out.append((path + ("scale",), f"{prefix}.weight", "plain"))
        out.append((path + ("bias",), f"{prefix}.bias", "plain"))

    def res_block(path, prefix, p):
        for k in ("1", "2", "3"):
            if f"conv{k}" in p:
                kernel(path + (f"conv{k}", "Conv_0"), f"{prefix}.conv{k}.conv",
                       p[f"conv{k}"]["Conv_0"], "conv")
                norm(path + (f"norm{k}",), f"{prefix}.norm{k}", p[f"norm{k}"])

    enc = params["encoder"]
    pe = ("encoder", "patch_embed")
    kernel(pe + ("Conv_0",), "encoder.patch_embed.proj",
           enc["patch_embed"]["Conv_0"], "conv")
    norm(pe + ("LayerNorm_0",), "encoder.patch_embed.norm",
         enc["patch_embed"]["LayerNorm_0"])
    i = 0
    while f"layers_{i}" in enc:
        layer, lp = enc[f"layers_{i}"], ("encoder", f"layers_{i}")
        j = 0
        while f"blocks_{j}" in layer:
            blk, bp = layer[f"blocks_{j}"], lp + (f"blocks_{j}",)
            base = f"encoder.layers.{i}.blocks.{j}"
            norm(bp + ("LayerNorm_0",), f"{base}.norm1", blk["LayerNorm_0"])
            norm(bp + ("LayerNorm_1",), f"{base}.norm2", blk["LayerNorm_1"])
            ap = bp + ("attn",)
            out.append((ap + ("qkv_kernel",), f"{base}.attn.qkv.weight", "dense"))
            if "qkv_bias" in blk["attn"]:
                out.append((ap + ("qkv_bias",), f"{base}.attn.qkv.bias", "plain"))
            out.append((ap + ("proj_kernel",), f"{base}.attn.proj.weight", "dense"))
            out.append((ap + ("proj_bias",), f"{base}.attn.proj.bias", "plain"))
            out.append((ap + ("relative_position_bias_table",),
                        f"{base}.attn.relative_position_bias_table", "plain"))
            for d, fc in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
                kernel(bp + ("Mlp_0", d), f"{base}.mlp.{fc}",
                       blk["Mlp_0"][d], "dense")
            j += 1
        down = layer["downsample"]
        norm(lp + ("downsample", "LayerNorm_0"),
             f"encoder.layers.{i}.downsample.norm", down["LayerNorm_0"])
        kernel(lp + ("downsample", "reduction", "Conv_0"),
               f"encoder.layers.{i}.downsample.reduction",
               down["reduction"]["Conv_0"], "conv")
        norm(("encoder", f"norm{i}"), f"encoder.norm{i}", enc[f"norm{i}"])
        i += 1

    dec = params["decoder"]
    k = 0
    while f"encoder{k}" in dec:
        res_block(("decoder", f"encoder{k}"), f"unet_encoders.{k}.layer",
                  dec[f"encoder{k}"])
        k += 1
    k = 0
    while f"decoder{k}" in dec:
        d, dp = dec[f"decoder{k}"], ("decoder", f"decoder{k}")
        kernel(dp + ("transp_conv", "ConvTranspose_0"),
               f"unet_decoders.{k}.transp_conv.conv",
               d["transp_conv"]["ConvTranspose_0"], "convT")
        res_block(dp + ("conv_block",), f"unet_decoders.{k}.conv_block",
                  d["conv_block"])
        k += 1
    kernel(("decoder", "out", "conv", "Conv_0"), "out.conv.conv",
           dec["out"]["conv"]["Conv_0"], "conv")
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX flagship tree {'encoder': ..., 'decoder': ...} (weights, or
    gradients or moments of the same structure) -> port state_dict."""
    return {key: _t(_TO_PORT[kind](np.asarray(_get(params, path))))
            for path, key, kind in key_map(params)}


def jax_tree_from_state_dict(sd: Dict[str, torch.Tensor],
                             template: Dict) -> Dict:
    """Port state_dict (or gradients keyed like it) -> nested dicts of numpy
    arrays in the JAX flagship's layout; ``template`` is any tree of that
    structure (only its keys are read)."""
    tree: Dict = {}
    for path, key, kind in key_map(template):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        a = sd[key].detach().cpu().numpy()
        node[path[-1]] = np.ascontiguousarray(_TO_JAX[kind](a))
    return tree


def load_adamw_state_from_optax(optimizer: torch.optim.Optimizer,
                                model: torch.nn.Module, mu: Dict, nu: Dict,
                                count: int) -> None:
    """Fill ``torch.optim.AdamW``'s state for ``model``'s parameters from an
    optax ``ScaleByAdamState``: first and second moments ``mu`` / ``nu``
    (trees shaped like the JAX parameters) and the update ``count``, so that
    the next update computes the same thing in both."""
    exp_avg, exp_avg_sq = state_dict_from_jax(mu), state_dict_from_jax(nu)
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": exp_avg[name].to(p.device, p.dtype),
            "exp_avg_sq": exp_avg_sq[name].to(p.device, p.dtype),
        }


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
