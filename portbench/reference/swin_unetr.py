"""Plain fp32 reference of MONAI's ``SwinUNETR`` (Hatamizadeh et al.,
arXiv:2201.01266) as MONAI v1 builds it: a patch-embedding conv, four stages
of pre-norm Swin blocks with per-axis windows (a window at least the grid's
size along an axis is clamped to it there and that axis is not shifted; the
grid is zero-padded up to the window; the bias table is the constructor
window's and its index is that window's sliced ``[:n, :n]``), MONAI v1's
patch merging (eight strided slices in its order, in which the 6th and 7th
repeat the 3rd and 4th, LayerNorm, a dense layer without bias), a
parameterless LayerNorm on every hidden state, and the 5-level UNETR
decoder.

``forward(P, cfg, vol, masks=None, prec=EXACT)`` as in
``nnformer_unetr.py``; ``masks`` are the DropPath keep masks of a training
step (:func:`draw_masks`, none at a drop-path rate of 0).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import common as c
from portbench.reference.precision import EXACT

WINDOW = (7, 7, 7)
PATCH = (2, 2, 2)
# the octants of MONAI v1's merging, in its order
OCTANTS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1),
           (0, 1, 0), (0, 0, 1), (1, 1, 1))


def _rates(cfg: Dict) -> List[float]:
    return np.linspace(0, cfg["drop_path_rate"], sum(cfg["depths"])).tolist()


def draw_masks(cfg: Dict, batch: int, generator: torch.Generator,
               device) -> List[Optional[torch.Tensor]]:
    """DropPath keep masks in forward order: per block with a rate above 0,
    one for the attention branch, then one for the MLP branch."""
    masks = []
    for rate in _rates(cfg):
        if rate == 0.0:
            masks += [None, None]
            continue
        for _ in range(2):
            masks.append(torch.rand(batch, generator=generator,
                                    device=device) < 1.0 - rate)
    return masks


def _block(x, P, name, nh, shift, rate, m_attn, m_mlp, prec):
    _, d, h, w, _ = x.shape
    ws = tuple(g if g <= wd else wd for g, wd in zip((d, h, w), WINDOW))
    ss = tuple(0 if g <= wd else s for g, wd, s in zip((d, h, w), WINDOW,
                                                        shift))
    n = ws[0] * ws[1] * ws[2]
    index = c.rel_index(WINDOW)[:n, :n]
    y = c.shifted_attention(c.layer_norm(x, P, name + ".norm1"), P,
                            name + ".attn", nh, ws, ss, index, prec,
                            qkv_bias=True)
    x = x + c.drop_path(y, m_attn, rate)
    y = c.mlp(c.layer_norm(x, P, name + ".norm2"), P, name + ".mlp", prec)
    return x + c.drop_path(y, m_mlp, rate)


def _merge(x, P, name, prec):
    _, d, h, w, _ = x.shape
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    x = torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in OCTANTS], dim=-1)
    return c.dense(c.layer_norm(x, P, name + ".norm"), P, name + ".reduction",
                   prec, bias=False)


def _proj_out(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-5)


def forward(P, cfg: Dict, vol: torch.Tensor,
            masks: Optional[List[Optional[torch.Tensor]]] = None,
            prec=EXACT) -> torch.Tensor:
    x = c.conv(vol, P, "swinViT.patch_embed.proj", prec, stride=PATCH,
               bias=True)
    z = [_proj_out(x)]
    rates = _rates(cfg)
    shift = tuple(w // 2 for w in WINDOW)
    k = 0
    for s, (depth, nh) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        base = f"swinViT.layers{s + 1}.0"
        for j in range(depth):
            m_attn, m_mlp = (masks[k], masks[k + 1]) if masks else (None, None)
            x = _block(x, P, f"{base}.blocks.{j}", nh,
                       shift if j % 2 else (0, 0, 0), rates[k // 2], m_attn,
                       m_mlp, prec)
            k += 2
        x = _merge(x, P, base + ".downsample", prec)
        z.append(_proj_out(x))
    y = c.up_block(c.res_block(z[4], P, "encoder10.layer", prec), z[3], P,
                   "decoder5", prec)
    y = c.up_block(y, c.res_block(z[2], P, "encoder4.layer", prec), P,
                   "decoder4", prec)
    y = c.up_block(y, c.res_block(z[1], P, "encoder3.layer", prec), P,
                   "decoder3", prec)
    y = c.up_block(y, c.res_block(z[0], P, "encoder2.layer", prec), P,
                   "decoder2", prec)
    y = c.up_block(y, c.res_block(vol, P, "encoder1.layer", prec), P,
                   "decoder1", prec)
    return c.out_block(y, P, "out", prec)
