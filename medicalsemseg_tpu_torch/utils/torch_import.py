"""MONAI and Video-Swin checkpoint imports (counterpart of the MONAI part
of medicalsemseg_tpu/utils/torch_import.py).

The JAX package converts these PyTorch state_dicts into flax trees; the
port's models keep the PyTorch layouts (``utils/params.py``), so here an
import is a renaming into the port's state_dict keys, the tensors kept
as they are: the ``state_dict`` / DDP ``module.`` wrappers dropped, MONAI's
``mlp.linear1`` / ``linear2`` named ``fc1`` / ``fc2`` as the SSL
checkpoints and the port name them, and Video-Swin's flat absolute position
table laid onto its patch grid. Only the leaves the JAX imports read are
taken, so a MONAI buffer (``relative_position_index``, masks) is left out.
Every function returns {port key: float32 tensor}; load it with
``model.load_state_dict(sd, strict=False)`` (an SSL encoder) or ``strict=True``
(a whole model).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from medicalsemseg_tpu_torch.utils.params import _interp_grid

Tensors = Dict[str, torch.Tensor]

# a block's leaves the JAX import reads: (name in the file, required)
_BLOCK_LEAVES = (("norm1.weight", True), ("norm1.bias", True),
                 ("norm2.weight", True), ("norm2.bias", True),
                 ("attn.relative_position_bias_table", True),
                 ("attn.qkv.weight", True), ("attn.qkv.bias", False),
                 ("attn.proj.weight", True), ("attn.proj.bias", False))


def _f32(t) -> torch.Tensor:
    t = torch.as_tensor(t.detach().cpu() if hasattr(t, "detach") else t)
    return t.to(torch.float32).contiguous().clone()


def _strip(sd: Dict) -> Dict:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _take(sd: Dict, src: str, out: Tensors, dst: str,
          required: bool = True) -> None:
    if src in sd:
        out[dst] = _f32(sd[src])
    elif required:
        raise KeyError(f"{src} is not in the checkpoint")


def _layer(sd: Dict, src: str, out: Tensors, dst: str,
           bias: bool = True) -> None:
    """A Linear / Conv / norm: its weight, and its bias where present."""
    _take(sd, f"{src}.weight", out, f"{dst}.weight")
    if bias:
        _take(sd, f"{src}.bias", out, f"{dst}.bias", required=False)


def _block(sd: Dict, src: str, out: Tensors, dst: str) -> None:
    """One MONAI / Video-Swin Swin block: norms, attention, and the MLP
    under ``fc1`` / ``fc2`` (SSL checkpoints) or ``linear1`` / ``linear2``
    (MONAI's MLPBlock in a trained model's own state_dict)."""
    for leaf, required in _BLOCK_LEAVES:
        _take(sd, f"{src}.{leaf}", out, f"{dst}.{leaf}", required)
    for fc, lin in (("fc1", "linear1"), ("fc2", "linear2")):
        name = fc if f"{src}.mlp.{fc}.weight" in sd else lin
        _layer(sd, f"{src}.mlp.{name}", out, f"{dst}.mlp.{fc}")


def _merging(sd: Dict, src: str, out: Tensors, dst: str) -> None:
    _layer(sd, f"{src}.norm", out, f"{dst}.norm")
    _layer(sd, f"{src}.reduction", out, f"{dst}.reduction", bias=False)


def _res_block(sd: Dict, src: str, out: Tensors) -> None:
    """MONAI UnetResBlock: conv1-2 (conv3 on a channel change) and their
    InstanceNorms where they are affine."""
    for k in ("1", "2", "3"):
        if k == "3" and f"{src}.conv3.conv.weight" not in sd:
            continue
        _layer(sd, f"{src}.conv{k}.conv", out, f"{src}.conv{k}.conv")
        if f"{src}.norm{k}.weight" in sd:
            _layer(sd, f"{src}.norm{k}", out, f"{src}.norm{k}")


def import_swin_unetr_official(weights: Dict,
                               depths: Sequence[int] = (2, 2, 2, 2)
                               ) -> Tensors:
    """MONAI SwinUNETR ``load_from``: the SSL-pretrained checkpoint
    ``weights['state_dict']['module.<...>']`` (or a bare state_dict) ->
    SwinUNETR_Official's ``swinViT.*`` keys (patch embedding, every block,
    every merging: what ``load_from`` covers; the decoder keeps its own
    initialisation)."""
    sd = _strip(weights.get("state_dict", weights))
    out: Tensors = {}
    _layer(sd, "patch_embed.proj", out, "swinViT.patch_embed.proj")
    for k, depth in enumerate(depths):
        stage = f"layers{k + 1}.0"
        for n in range(depth):
            _block(sd, f"{stage}.blocks.{n}", out,
                   f"swinViT.{stage}.blocks.{n}")
        _merging(sd, f"{stage}.downsample", out, f"swinViT.{stage}.downsample")
    return out


def import_swin_unetr_official_full(state_dict: Dict,
                                    depths: Sequence[int] = (2, 2, 2, 2)
                                    ) -> Tensors:
    """A whole MONAI SwinUNETR state_dict (encoder and decoder) ->
    SwinUNETR_Official's state_dict."""
    sd = _strip(state_dict)
    out = import_swin_unetr_official(
        {k[len("swinViT."):]: v for k, v in sd.items()
         if k.startswith("swinViT.")}, depths)
    for name in ("encoder1", "encoder2", "encoder3", "encoder4", "encoder10"):
        _res_block(sd, f"{name}.layer", out)
    for k in range(1, 6):
        _layer(sd, f"decoder{k}.transp_conv.conv", out,
               f"decoder{k}.transp_conv.conv")
        _res_block(sd, f"decoder{k}.conv_block", out)
    _layer(sd, "out.conv.conv", out, "out.conv.conv")
    return out


def import_video_swin(state_dict: Dict, depths: Sequence[int] = (2, 2, 2, 2),
                      grid=None) -> Tensors:
    """Video-Swin ``SwinTransformer3D`` state_dict -> VideoSwinUNETR's
    ``encoder.*`` keys. The flat ``absolute_pos_embed`` (1, N, C) is laid
    onto the (d, h, w) patch ``grid`` in grid-major order, as the JAX
    import does."""
    sd = _strip(state_dict)
    out: Tensors = {}
    _layer(sd, "patch_embed.proj", out, "encoder.patch_embed.proj")
    if "patch_embed.norm.weight" in sd:
        _layer(sd, "patch_embed.norm", out, "encoder.patch_embed.norm")
    if "absolute_pos_embed" in sd:
        ape = _f32(sd["absolute_pos_embed"])
        out["encoder.absolute_pos_embed"] = ape.reshape(
            1, *grid, ape.shape[-1]).contiguous()
    for k, depth in enumerate(depths):
        for i in range(depth):
            _block(sd, f"layers.{k}.blocks.{i}", out,
                   f"encoder.layers.{k}.blocks.{i}")
        _merging(sd, f"layers.{k}.downsample", out,
                 f"encoder.layers.{k}.downsample")
    return out


def resize_abs_pos_embed(pos: np.ndarray, src_grid, dst_grid,
                         num_extra_tokens: int = 0) -> np.ndarray:
    """Resize a (1, N + extra, C) (or (N + extra, C)) 3D absolute position
    embedding to another token grid, trilinearly (align_corners=False);
    the extra (class) tokens stay in front, unchanged."""
    src_grid, dst_grid = tuple(src_grid), tuple(dst_grid)
    squeeze = pos.ndim == 2
    if squeeze:
        pos = pos[None]
    extra = pos[:, :num_extra_tokens]
    tokens = pos[:, num_extra_tokens:]
    c = tokens.shape[-1]
    if tokens.shape[1] != int(np.prod(src_grid)):
        raise ValueError(f"{tokens.shape[1]} tokens do not fill the grid "
                         f"{src_grid}")
    grid = tokens.reshape(*src_grid, c).astype(np.float32)
    resized = _interp_grid(grid, dst_grid).reshape(1, -1, c)
    out = np.concatenate([extra.astype(np.float32), resized], axis=1)
    return out[0] if squeeze else out
