"""Plain building blocks of the reference models, written from the published
descriptions (Swin Transformer's shifted windows, MONAI's UNETR blocks) in
fp32 PyTorch, independent of the program under test.

Every function works on one crop or a few windows at a time, channels-last
(B, D, H, W, C), and reads its weights from ``P``, a dict of name -> tensor
with the names of the program's ``state_dict`` (so the benchmark hands both
sides the same dict). Every product goes through ``prec`` (``precision.py``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tuple3 = Tuple[int, int, int]
Params = Dict[str, torch.Tensor]


def ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


def layer_norm(x, P: Params, name: str, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"],
                        P[name + ".bias"], eps)


def dense(x, P: Params, name: str, prec, bias: bool = True):
    return prec.linear(x, P[name + ".weight"],
                       P.get(name + ".bias") if bias else None)


def instance_norm(x, P: Params, name: str, eps: float = 1e-5):
    """Affine InstanceNorm over the spatial axes, population variance."""
    var, mean = torch.var_mean(x, dim=(1, 2, 3), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * P[name + ".weight"] \
        + P[name + ".bias"]


def conv(x, P: Params, name: str, prec, stride=1, padding=0, bias=False):
    """A 3D convolution of a channels-last volume; weight (O, I, k, k, k)."""
    w = P[name + ".weight"]
    b = P.get(name + ".bias") if bias else None
    return ndhwc(prec.conv3d(ncdhw(x), w, b, stride=stride, padding=padding))


def leaky_relu(x):
    return F.leaky_relu(x, 0.01)


# -- the UNETR decoder's blocks (MONAI UnetResBlock, UnetrUpBlock,
# UnetOutBlock) --

def res_block(x, P: Params, name: str, prec):
    """conv3-IN-lrelu-conv3-IN, plus conv1-IN on the shortcut where the
    channels change, then lrelu."""
    y = conv(x, P, name + ".conv1.conv", prec, padding=1)
    y = leaky_relu(instance_norm(y, P, name + ".norm1"))
    y = conv(y, P, name + ".conv2.conv", prec, padding=1)
    y = instance_norm(y, P, name + ".norm2")
    if name + ".conv3.conv.weight" in P:
        x = instance_norm(conv(x, P, name + ".conv3.conv", prec),
                          P, name + ".norm3")
    return leaky_relu(y + x)


def up_block(x, skip, P: Params, name: str, prec):
    """Transposed conv (kernel = stride), concat the skip, res block."""
    w = P[name + ".transp_conv.conv.weight"]
    x = ndhwc(prec.conv_transpose3d(ncdhw(x), w, stride=tuple(w.shape[2:])))
    return res_block(torch.cat([x, skip], dim=-1), P, name + ".conv_block",
                     prec)


def out_block(x, P: Params, name: str, prec):
    return conv(x, P, name + ".conv.conv", prec, bias=True)


# -- shifted windows --

def pad_to(x, ws: Sequence[int]):
    """Zero-pad the trailing edge of each spatial axis to a multiple."""
    _, d, h, w, _ = x.shape
    pd, ph, pw = (-d) % ws[0], (-h) % ws[1], (-w) % ws[2]
    if pd == ph == pw == 0:
        return x
    return F.pad(x, (0, 0, 0, pw, 0, ph, 0, pd))


def partition(x, ws: Sequence[int]):
    """(B, D, H, W, C) -> (B * nW, N, C), windows batch- then depth-major."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2],
                  c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        -1, ws[0] * ws[1] * ws[2], c)


def unpartition(wins, ws: Sequence[int], dims: Sequence[int]):
    d, h, w = dims
    b = wins.shape[0] // ((d // ws[0]) * (h // ws[1]) * (w // ws[2]))
    x = wins.reshape(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1],
                     ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


@functools.lru_cache(maxsize=None)
def _region_mask(dims: Tuple3, ws: Tuple3, ss: Tuple3) -> np.ndarray:
    """Swin's shifted-window mask (nW, N, N): -100 between tokens of
    different regions of the rolled grid; an axis with no shift has two
    regions, the last window and the rest."""
    img = np.zeros(dims, np.int64)
    cnt = 0

    def spans(w, s):
        return ((slice(0, -w), slice(-w, -s), slice(-s, None)) if s
                else (slice(0, -w), slice(-w, None)))

    for a in spans(ws[0], ss[0]):
        for b in spans(ws[1], ss[1]):
            for c in spans(ws[2], ss[2]):
                img[a, b, c] = cnt
                cnt += 1
    win = partition(torch.from_numpy(img)[None, ..., None], ws)[..., 0]
    win = win.numpy()
    return np.where(win[:, None, :] != win[:, :, None], -100.0,
                    0.0).astype(np.float32)


def region_mask(dims, ws, ss, device) -> torch.Tensor:
    return torch.from_numpy(_region_mask(tuple(dims), tuple(ws),
                                         tuple(ss))).to(device)


@functools.lru_cache(maxsize=None)
def rel_index(ws: Tuple3) -> np.ndarray:
    """(N, N) index into the ((2w0-1)(2w1-1)(2w2-1), nh) bias table."""
    coords = np.stack(np.meshgrid(*[np.arange(w) for w in ws],
                                  indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + np.asarray(ws) - 1
    return (rel[..., 0] * (2 * ws[1] - 1) * (2 * ws[2] - 1)
            + rel[..., 1] * (2 * ws[2] - 1) + rel[..., 2])


def window_attention(wins, P: Params, name: str, nh: int, index: np.ndarray,
                     mask: Optional[torch.Tensor], prec, qkv_bias: bool):
    """Multi-head self-attention inside each window of LN'd tokens
    (T, N, C) with the relative-position bias and the shift mask."""
    t, n, c = wins.shape
    hd = c // nh
    qkv = dense(wins, P, name + ".qkv", prec, bias=qkv_bias)
    q, k, v = qkv.reshape(t, n, 3, nh, hd).permute(2, 0, 3, 1, 4).unbind(0)
    attn = prec.matmul(q * hd ** -0.5, k.transpose(-1, -2))
    table = P[name + ".relative_position_bias_table"]
    idx = torch.from_numpy(index.reshape(-1)).to(table.device)
    bias = table[idx].reshape(n, n, nh).permute(2, 0, 1)
    attn = attn + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(t // nw, nw, nh, n, n)
                + mask[None, :, None]).reshape(t, nh, n, n)
    out = prec.matmul(torch.softmax(attn, dim=-1), v)
    out = out.permute(0, 2, 1, 3).reshape(t, n, c)
    return dense(out, P, name + ".proj", prec)


def shifted_attention(xn, P: Params, name: str, nh: int, ws: Tuple3,
                      ss: Tuple3, index: np.ndarray, prec, qkv_bias: bool):
    """The attention branch of a Swin block on LN'd tokens (B, D, H, W, C):
    pad to the window, roll by -shift, attend inside windows, roll back,
    crop."""
    _, d, h, w, _ = xn.shape
    xp = pad_to(xn, ws)
    dims = xp.shape[1:4]
    mask = None
    if any(ss):
        xp = torch.roll(xp, shifts=tuple(-s for s in ss), dims=(1, 2, 3))
        mask = region_mask(dims, ws, ss, xn.device)
    out = window_attention(partition(xp, ws), P, name, nh, index, mask, prec,
                           qkv_bias)
    y = unpartition(out, ws, dims)
    if any(ss):
        y = torch.roll(y, shifts=tuple(ss), dims=(1, 2, 3))
    return y[:, :d, :h, :w]


def drop_path(x, keep_mask: Optional[torch.Tensor], rate: float):
    """Stochastic depth with a given (B,) bool keep mask."""
    if keep_mask is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    m = keep_mask.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(m, x / keep, torch.zeros_like(x))


def mlp(x, P: Params, name: str, prec):
    return dense(F.gelu(dense(x, P, name + ".fc1", prec)), P, name + ".fc2",
                 prec)
