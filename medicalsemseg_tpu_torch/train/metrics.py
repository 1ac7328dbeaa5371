"""Per-class Dice and the 95 % Hausdorff distance (counterpart of
medicalsemseg_tpu/train/metrics.py: ``dice_per_class`` and ``mean_dice``,
MONAI DiceMetric semantics; ``hausdorff95``, MONAI
HausdorffDistanceMetric(percentile=95)).

HD95 runs on the host (scipy's distance transform over the union bounding
box of both surfaces) or, with ``device=True`` (``--device_hd95``), as
chunked nearest-neighbour products d^2 = |p|^2 + |t|^2 - 2 p.t on a torch
device; both give the same bits (integer-exact fp32 products, sqrt in fp64
on the host).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_SPATIAL = (1, 2, 3)


def dice_per_class(pred_labels: torch.Tensor, true_labels: torch.Tensor,
                   n_classes: int, mask=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, D, H, W) int predictions/labels -> ((B, C) dice, (B, C) not_nan).

    dice is 0 where not_nan is 0 (the class is absent from the ground
    truth). An optional 0/1 ``mask`` (B, D, H, W) restricts all counts to the
    masked voxels."""
    p = F.one_hot(pred_labels.long(), n_classes).float()
    g = F.one_hot(true_labels.long(), n_classes).float()
    if mask is not None:
        m = mask.float()[..., None]
        p, g = p * m, g * m
    inter = (p * g).sum(_SPATIAL)
    p_o, g_o = p.sum(_SPATIAL), g.sum(_SPATIAL)
    not_nan = (g_o > 0).float()
    denom = p_o + g_o
    dice = torch.where(denom > 0, 2.0 * inter / torch.clamp(denom, min=1.0),
                       torch.zeros_like(denom))
    return dice * not_nan, not_nan


def mean_dice(dice: torch.Tensor, not_nan: torch.Tensor) -> torch.Tensor:
    """NaN-aware mean over the batch, then over the classes that occur."""
    counts = not_nan.sum(0)
    means = dice.sum(0) / torch.clamp(counts, min=1.0)
    valid = counts > 0
    return (torch.where(valid, means, torch.zeros_like(means)).sum()
            / torch.clamp(valid.sum(), min=1))


def _surface_points(mask: np.ndarray) -> np.ndarray:
    """Border voxels of a binary mask (erosion-based edge extraction)."""
    from scipy.ndimage import binary_erosion

    if not mask.any():
        return np.zeros((0, mask.ndim), dtype=np.int64)
    eroded = binary_erosion(mask, border_value=0)
    return np.argwhere(mask & ~eroded)


# fp32 represents every integer < 2^24 exactly; the largest intermediate is
# |p|^2 + |t|^2 <= 6 * maxcoord^2, so exactness needs maxcoord <= 1672.
# Beyond that hausdorff95 takes the host EDT.
_DEVICE_EXACT_MAX_COORD = 1672
# query points a product, and targets a product: a (512, 65536) fp32 slab
# is 128 MB
_P_CHUNK = 512
_T_CHUNK = 65536


def _nn_min_dists_device(ps: np.ndarray, ts: np.ndarray,
                         on: torch.device) -> np.ndarray:
    """Euclidean distance from each point of ``ps`` (P, 3) to the nearest of
    ``ts`` (T, 3), as d^2 = |p|^2 + |t|^2 - 2 p.t on ``on``: queries in
    chunks of 512 rows, targets in chunks of at most 65,536, the min kept
    over the target chunks (eager PyTorch needs no shape buckets, so no
    target slot is padded). Every coordinate is <= 1672, so each term is an
    integer below 2^24 and the fp32 arithmetic is exact, provided the
    product runs in true fp32: TF32 is switched off around it (and the
    caller's setting restored). The sqrt is taken in fp64 on the host, so
    the result equals the distance transform's bit for bit."""
    assert max(ps.max(initial=0), ts.max(initial=0)) <= _DEVICE_EXACT_MAX_COORD
    p = torch.from_numpy(ps.astype(np.float32)).to(on)
    t = torch.from_numpy(ts.astype(np.float32)).to(on)
    d2 = torch.full((len(ps),), float("inf"), dtype=torch.float32, device=on)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for t0 in range(0, len(ts), _T_CHUNK):
            tc = t[t0:t0 + _T_CHUNK]
            t2 = (tc * tc).sum(-1)
            for p0 in range(0, len(ps), _P_CHUNK):
                pc = p[p0:p0 + _P_CHUNK]
                dd = ((pc * pc).sum(-1)[:, None] + t2[None, :]
                      - 2.0 * torch.matmul(pc, tc.t()))
                d2[p0:p0 + _P_CHUNK] = torch.minimum(
                    d2[p0:p0 + _P_CHUNK], dd.min(1).values)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return np.sqrt(d2.cpu().numpy().astype(np.float64))


def hausdorff95(pred: np.ndarray, target: np.ndarray, n_classes: int,
                include_background: bool = False, device: bool = False,
                on: Optional[torch.device] = None) -> np.ndarray:
    """(D, H, W) int arrays -> per-class HD95: NaN where a class is absent
    from both, inf where from one.

    The directed distances of each surface to the other come from the
    Euclidean distance transform, cropped to the union bounding box of both
    surfaces (exactly the full-volume transform: every query point lies in
    the box). With ``device`` they come from :func:`_nn_min_dists_device`
    on ``on`` (default ``cuda``) instead, after both surfaces are shifted to
    their union box's origin; a class whose shifted coordinates pass 1672
    takes the host transform, the bound of exact fp32."""
    from scipy.ndimage import distance_transform_edt

    on = torch.device("cuda") if on is None else torch.device(on)
    start = 0 if include_background else 1
    out = np.full(n_classes - start, np.nan)
    for ci, c in enumerate(range(start, n_classes)):
        ps = _surface_points(pred == c)
        ts = _surface_points(target == c)
        if len(ps) == 0 or len(ts) == 0:
            out[ci] = np.nan if len(ps) == len(ts) else np.inf
            continue
        if device:
            lo = np.minimum(ps.min(axis=0), ts.min(axis=0))
            ps_d, ts_d = ps - lo, ts - lo
            if max(ps_d.max(), ts_d.max()) <= _DEVICE_EXACT_MAX_COORD:
                d_pt = _nn_min_dists_device(ps_d, ts_d, on)
                d_tp = _nn_min_dists_device(ts_d, ps_d, on)
                out[ci] = max(np.percentile(d_pt, 95),
                              np.percentile(d_tp, 95))
                continue
        both = np.concatenate([ps, ts], axis=0)
        lo = both.min(axis=0)
        hi = both.max(axis=0) + 1
        ps_c, ts_c = ps - lo, ts - lo
        t_surf = np.zeros(tuple(hi - lo), bool)
        t_surf[tuple(ts_c.T)] = True
        p_surf = np.zeros_like(t_surf)
        p_surf[tuple(ps_c.T)] = True
        d_pt = distance_transform_edt(~t_surf)[tuple(ps_c.T)]
        d_tp = distance_transform_edt(~p_surf)[tuple(ts_c.T)]
        out[ci] = max(np.percentile(d_pt, 95), np.percentile(d_tp, 95))
    return out
