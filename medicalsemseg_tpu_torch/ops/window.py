"""3D shifted-window primitives (counterpart of medicalsemseg_tpu/ops/window.py).

Volumes are channels-last (B, D, H, W, C) tensors. Window partition/reverse
are reshapes + permutes in batch-major window order, the order the window
attention kernel derives its shifted-window mask from. The index and mask
builders are NumPy, computed once per shape and cached.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tuple3 = Tuple[int, int, int]


def _ws3(window_size) -> Tuple3:
    return ((int(window_size),) * 3 if np.isscalar(window_size)
            else tuple(int(v) for v in window_size))


def pad_to_multiple(x: torch.Tensor, multiple: Tuple3) -> torch.Tensor:
    """Zero-pad the trailing edge of the three spatial dims of (B, D, H, W, C)
    up to the next multiple."""
    _, d, h, w, _ = x.shape
    pd, ph, pw = ((-d) % multiple[0], (-h) % multiple[1], (-w) % multiple[2])
    if pd == ph == pw == 0:
        return x
    # F.pad pads from the last dim backwards: (C, W, H, D)
    return F.pad(x, (0, 0, 0, pw, 0, ph, 0, pd))


def roll3(x: torch.Tensor, shift) -> torch.Tensor:
    """Cyclic roll of the three spatial dims of (B, D, H, W, C) by ``shift``,
    one value for all three or one per axis."""
    s3 = _ws3(shift)
    if not any(s3):
        return x
    return torch.roll(x, shifts=s3, dims=(1, 2, 3))


def window_partition(x: torch.Tensor, window_size) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * nW, prod(ws), C) for a cubic (int) or
    per-axis (tuple) window, windows ordered batch-major then depth-major:
    g = ((b * nwd + i) * nwh + j) * nww + k."""
    b, d, h, w, c = x.shape
    w0, w1, w2 = _ws3(window_size)
    x = x.reshape(b, d // w0, w0, h // w1, w1, w // w2, w2, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, w0 * w1 * w2, c)


def window_reverse(windows: torch.Tensor, window_size,
                   dims: Tuple3) -> torch.Tensor:
    """Inverse of :func:`window_partition`: (B * nW, prod(ws), C) ->
    (B, D, H, W, C)."""
    d, h, w = dims
    w0, w1, w2 = _ws3(window_size)
    n_win = (d // w0) * (h // w1) * (w // w2)
    b = windows.shape[0] // n_win
    c = windows.shape[-1]
    x = windows.reshape(b, d // w0, h // w1, w // w2, w0, w1, w2, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, w, c)


@functools.lru_cache(maxsize=None)
def _official_attn_mask(dims: Tuple3, ws: Tuple3, ss: Tuple3) -> np.ndarray:
    """Region-id SW-MSA mask of MONAI's ``compute_mask`` over a (D, H, W)
    grid that is a multiple of the per-axis window ``ws``, with a per-axis
    shift ``ss`` that may be 0 on some axes (that axis then has two
    regions, the last window and the rest, which no window mixes): tokens
    from different pre-shift regions get -100. Returns (nW, N, N) float32."""
    img = np.zeros(dims, np.int32)
    cnt = 0

    def spans(w, s):
        # the last two slices collapse into one when the axis is not shifted
        return ((slice(0, -w), slice(-w, -s), slice(-s, None)) if s
                else (slice(0, -w), slice(-w, None)))

    for sd in spans(ws[0], ss[0]):
        for sh in spans(ws[1], ss[1]):
            for sw in spans(ws[2], ss[2]):
                img[sd, sh, sw] = cnt
                cnt += 1
    d, h, w = dims
    win = img.reshape(d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2],
                      ws[2]).transpose(0, 2, 4, 1, 3, 5).reshape(
                          -1, ws[0] * ws[1] * ws[2])
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def shift_mask(dims: Tuple3, window_size, shift_size,
               device: torch.device) -> torch.Tensor:
    """:func:`_official_attn_mask` of a cubic (int) or per-axis window and
    shift as a tensor on ``device``, made once per grid, window, shift and
    device (the unfused attentions add it to every call's logits)."""
    return torch.from_numpy(_official_attn_mask(
        dims, _ws3(window_size), _ws3(shift_size))).to(device)


@functools.lru_cache(maxsize=None)
def relative_position_index(window_size: Tuple3) -> np.ndarray:
    """(ws³, ws³) int32 index into the (2w0-1)(2w1-1)(2w2-1) rel-pos table."""
    w0, w1, w2 = window_size
    coords = np.stack(np.meshgrid(np.arange(w0), np.arange(w1), np.arange(w2),
                                  indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += w0 - 1
    rel[:, :, 1] += w1 - 1
    rel[:, :, 2] += w2 - 1
    rel[:, :, 0] *= (2 * w1 - 1) * (2 * w2 - 1)
    rel[:, :, 1] *= 2 * w2 - 1
    return rel.sum(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def relative_position_index_ref_quirk(window_size: Tuple3) -> np.ndarray:
    """The reference's non-standard index for GC-ViT: strides (3 w1 - 1,
    2 w1 - 1, 1) instead of ((2 w1 - 1)(2 w2 - 1), 2 w2 - 1, 1), which maps
    distinct relative offsets onto shared table entries. Kept behind
    ``--ref_quirk_rel_pos`` so that reference checkpoints of that model load
    bit-compatibly."""
    w0, w1, w2 = window_size
    coords = np.stack(np.meshgrid(np.arange(w0), np.arange(w1), np.arange(w2),
                                  indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += w0 - 1
    rel[:, :, 1] += w1 - 1
    rel[:, :, 2] += w2 - 1
    rel[:, :, 0] *= 3 * w1 - 1
    rel[:, :, 1] *= 2 * w1 - 1
    return rel.sum(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _full_window_index(window: Tuple3) -> np.ndarray:
    """The rel-pos index of the constructor window (the arithmetic of
    :func:`relative_position_index`), kept apart because the MONAI blocks
    slice it ``[:n, :n]`` at a clamped runtime window of n tokens, which
    is not the clamped window's own index."""
    return relative_position_index(tuple(window))


def gather_rel_bias(table: torch.Tensor, rel_index: torch.Tensor,
                    n: int) -> torch.Tensor:
    """(L, nh) bias table and (N * N,) index -> contiguous (nh, N, N) fp32
    bias, the form the attention kernels take."""
    bias = table.float()[rel_index].reshape(n, n, table.shape[1])
    return bias.permute(2, 0, 1).contiguous()


def resolve_window(input_resolution: Sequence[int], window_size: int,
                   shift_size: int) -> Tuple[int, int]:
    """Clamp window/shift for small grids: a window covering the whole grid
    attends globally and is not shifted."""
    if min(input_resolution) <= window_size:
        return min(input_resolution), 0
    return window_size, shift_size


def resolve_window_official(x_size: Tuple3, window: Tuple3,
                            shift: Tuple3) -> Tuple[Tuple3, Tuple3]:
    """MONAI's ``get_window_size``: per axis, a window at least the grid's
    size is clamped to it and that axis's shift set to 0."""
    ws, ss = list(window), list(shift)
    for i in range(3):
        if x_size[i] <= window[i]:
            ws[i], ss[i] = x_size[i], 0
    return tuple(ws), tuple(ss)
