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
:func:`load_pretrained_encoder` puts the ``encoder.*`` weights of a reference
checkpoint into a model, resizing relative-position bias tables that were
trained with another window size.
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


def _interp_grid(arr: np.ndarray, dst_shape) -> np.ndarray:
    """Trilinear resize of a (S1, S2, S3, C) grid to (*dst_shape, C) with
    align_corners=False sampling (torch F.interpolate semantics)."""
    from scipy.ndimage import map_coordinates

    src = arr.shape[:3]
    axes = [np.clip((np.arange(d) + 0.5) * s / d - 0.5, 0, s - 1)
            for d, s in zip(dst_shape, src)]
    grid = np.meshgrid(*axes, indexing="ij")
    coords = np.stack([g.ravel() for g in grid])
    out = np.empty(tuple(dst_shape) + arr.shape[3:], np.float32)
    for c in range(arr.shape[3]):
        out[..., c] = map_coordinates(
            arr[..., c].astype(np.float64), coords, order=1,
            mode="nearest").reshape(dst_shape)
    return out


def resize_rel_pos_bias_table(table: np.ndarray, src_window,
                              dst_window) -> np.ndarray:
    """Resize a 3D-window relative-position bias table across window sizes:
    (prod(2 ws - 1), nH) -> (prod(2 wd - 1), nH), the (2w - 1)^3 displacement
    grid resized trilinearly (align_corners=False) per head."""
    def grid_of(window):
        w3 = window if hasattr(window, "__len__") else (window,) * 3
        return tuple(2 * int(w) - 1 for w in w3)

    src, dst = grid_of(src_window), grid_of(dst_window)
    nh = table.shape[-1]
    if table.shape[0] != int(np.prod(src)):
        raise ValueError(f"table rows {table.shape[0]} != prod{src}")
    if src == dst:
        return table.astype(np.float32)
    grid = table.reshape(*src, nh).astype(np.float32)
    return _interp_grid(grid, dst).reshape(-1, nh)


def load_pretrained_encoder(model: torch.nn.Module, path: str) -> List[str]:
    """Load the ``encoder.*`` weights of the reference-format checkpoint at
    ``path`` into ``model`` (the rest of the model keeps its values) and
    return the keys loaded. A relative-position bias table whose row count
    differs from the model's (2 w - 1)^3 comes from another (cubic) window
    size and is resized to the model's. Raises if an encoder key of the
    model is missing from the file or the file has one the model lacks."""
    def window_of(rows: int) -> Tuple[int, int, int]:
        return (int(round((rows ** (1 / 3) + 1) / 2)),) * 3

    own = model.state_dict()
    enc = {k: v for k, v in load_checkpoint(path).items()
           if k.startswith("encoder.")}
    for key, value in enc.items():
        if (key.endswith("relative_position_bias_table") and key in own
                and value.shape[0] != own[key].shape[0]):
            enc[key] = torch.from_numpy(resize_rel_pos_bias_table(
                value.float().numpy(), window_of(value.shape[0]),
                window_of(own[key].shape[0])))
    missing, unexpected = model.load_state_dict(enc, strict=False)
    missing = [k for k in missing if k.startswith("encoder.")]
    if missing or unexpected:
        raise KeyError(f"{path}: encoder keys missing {missing[:5]}, "
                       f"unexpected {list(unexpected)[:5]}")
    return sorted(enc)
