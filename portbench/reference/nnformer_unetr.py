"""Plain fp32 reference of ``nnFormerUNETR``: a 3D Swin encoder (patch
embedding with LayerNorm; stages of W-MSA / SW-MSA blocks with a dense MLP;
merging by GELU, LayerNorm and a 3^3 stride-2 conv; a LayerNorm on each
merged output) under the UNETR decoder of MONAI's blocks.

``forward(P, cfg, vol, masks=None, prec=EXACT)``: ``vol`` (B, D, H, W, 1)
fp32, ``P`` the weights by the program's state_dict names, ``cfg`` the
configuration file's ``flags``; returns (B, D, H, W, n_classes) logits.
``masks`` gives the DropPath keep masks of a training step
(:func:`draw_masks`); without it the forward is the inference one.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import common as c
from portbench.reference.precision import EXACT


def _t3(v):
    return tuple(v) if isinstance(v, (list, tuple)) and len(v) == 3 else \
        ((v[0] if isinstance(v, (list, tuple)) else v),) * 3


def stages(cfg: Dict) -> List[Dict]:
    """Each stage's grid, channels, heads, window, blocks and the blocks'
    DropPath rates, at the configuration's crop."""
    vol, patch = _t3(cfg["vol_size"]), _t3(cfg["patch_size"])
    depths, heads = list(cfg["depths"]), list(cfg["num_heads"])
    win = cfg["window_size"]
    wins = [win] * len(depths) if not isinstance(win, list) else \
        (win * len(depths) if len(win) == 1 else win)
    dpr = np.linspace(0, cfg["drop_path_rate"], sum(depths)).tolist()
    grid = tuple(-(-s // p) for s, p in zip(vol, patch))
    out = []
    for i, depth in enumerate(depths):
        clamp = min(grid) <= wins[i]
        ws = min(grid) if clamp else wins[i]
        out.append({"grid": grid, "dim": cfg["hidden_dim"] * 2 ** i,
                    "heads": heads[i], "window": ws,
                    "shift": 0 if clamp else wins[i] // 2, "depth": depth,
                    "rates": dpr[sum(depths[:i]):sum(depths[:i + 1])]})
        grid = tuple(-(-g // 2) for g in grid)
    return out


def draw_masks(cfg: Dict, batch: int, generator: torch.Generator,
               device) -> List[Optional[torch.Tensor]]:
    """One training step's DropPath keep masks, (batch,) bool each, drawn in
    the order of the forward: every block with a rate above 0 draws one for
    its attention branch, then one for its MLP branch."""
    masks = []
    for st in stages(cfg):
        for j in range(st["depth"]):
            rate = st["rates"][j]
            if rate == 0.0:
                masks += [None, None]
                continue
            for _ in range(2):
                masks.append(torch.rand(batch, generator=generator,
                                        device=device) < 1.0 - rate)
    return masks


def forward(P, cfg: Dict, vol: torch.Tensor,
            masks: Optional[List[Optional[torch.Tensor]]] = None,
            prec=EXACT) -> torch.Tensor:
    patch = _t3(cfg["patch_size"])
    # patch embedding: kernel = stride conv (trailing edges zero-padded)
    pads = [(-vol.shape[i + 1]) % p for i, p in enumerate(patch)]
    x = F.pad(vol, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    x = c.conv(x, P, "encoder.patch_embed.proj", prec, stride=patch,
               bias=True)
    x = c.layer_norm(x, P, "encoder.patch_embed.norm")
    z = [x]
    k = 0
    for i, st in enumerate(stages(cfg)):
        ws, ss = (st["window"],) * 3, (st["shift"],) * 3
        base = f"encoder.layers.{i}"
        for j in range(st["depth"]):
            name = f"{base}.blocks.{j}"
            rate = st["rates"][j]
            m_attn, m_mlp = (masks[k], masks[k + 1]) if masks else (None, None)
            k += 2
            shift = ss if j % 2 else (0, 0, 0)
            y = c.shifted_attention(c.layer_norm(x, P, name + ".norm1"), P,
                                    name + ".attn", st["heads"], ws, shift,
                                    c.rel_index(ws), prec, qkv_bias=False)
            x = x + c.drop_path(y, m_attn, rate)
            y = c.mlp(c.layer_norm(x, P, name + ".norm2"), P, name + ".mlp",
                      prec)
            x = x + c.drop_path(y, m_mlp, rate)
        x = c.layer_norm(F.gelu(x), P, base + ".downsample.norm")
        x = c.conv(x, P, base + ".downsample.reduction", prec, stride=2,
                   padding=1, bias=True)
        z.append(c.layer_norm(x, P, f"encoder.norm{i}"))
    return decode(P, vol, z, prec)


def decode(P, vol, z, prec) -> torch.Tensor:
    """The UNETR decoder over the pyramid z (stem, then each merged stage)
    and the raw volume."""
    enc0 = c.res_block(vol, P, "unet_encoders.0.layer", prec)
    enc = [c.res_block(z[k], P, f"unet_encoders.{k + 1}.layer", prec)
           for k in range(len(z))]
    x = enc[-1]
    for i in range(len(z) - 2, -1, -1):
        x = c.up_block(x, enc[i], P, f"unet_decoders.{i + 1}", prec)
    x = c.up_block(x, enc0, P, "unet_decoders.0", prec)
    return c.out_block(x, P, "out", prec)
