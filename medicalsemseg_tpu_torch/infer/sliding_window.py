"""Gaussian-blended sliding-window inference (counterpart of
medicalsemseg_tpu/infer/sliding_window.py).

The window grid, the normalised window centres and the importance map are
computed host-side in NumPy, as in the JAX package (MONAI semantics). The
loop runs eagerly over batches of ``sw_batch`` windows: gather the windows
on the device, call the predictor once per batch, and blend each window's
class-major probabilities into the output and count volumes by indexed adds,
in window order, as the JAX ``fori_loop`` does. Each predictor call is
three spans, ``sw.gather``, ``sw.predictor`` and ``sw.blend`` (with the
call's ``windows``), and the divide by the counts with the crop is
``sw.normalise``; :func:`rank_volumes`' padding of a volume is ``sw.pad``
(``utils/profiling.py``).

Over several processes (``torch.distributed``): :func:`rank_volumes` hands
each rank whole volumes, which it predicts with the one-device function
(validation, test and evaluation spread their volumes so), and
:func:`sliding_window_inference_sharded` splits one volume's windows over
the ranks and sums their partial blends with one all_reduce.
:func:`grouped_padded_volumes` is the JAX package's grouping of volumes
into same-shaped stacks.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Callable, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.utils import profiling

Tuple3 = Tuple[int, int, int]


def bucket_pad(vol: np.ndarray, multiple: int = 32,
               cval: float = 0.0) -> Tuple[np.ndarray, Tuple3]:
    """Pad a (D, H, W, C) host volume at its trailing edges to the next
    spatial multiple with air (cval). Returns (padded, original shape)."""
    orig = vol.shape[:3]
    pads = [(0, (-orig[i]) % multiple) for i in range(3)] + [(0, 0)]
    if any(p != (0, 0) for p in pads):
        vol = np.pad(vol, pads, constant_values=cval)
    return vol, orig


def scan_interval(image_size: Tuple3, roi_size: Tuple3,
                  overlap: float) -> Tuple3:
    """MONAI _get_scan_interval semantics."""
    return tuple(roi_size[i] if roi_size[i] == image_size[i]
                 else max(int(roi_size[i] * (1.0 - overlap)), 1)
                 for i in range(3))


def dense_patch_starts(image_size: Tuple3, roi_size: Tuple3,
                       interval: Tuple3) -> np.ndarray:
    """All window start coordinates, clamped to stay in bounds (MONAI
    dense_patch_slices), depth-major. (N, 3) int."""
    per_dim = []
    for d in range(3):
        n = int(math.ceil((image_size[d] - roi_size[d]) / interval[d])) + 1
        starts = []
        for idx in range(n):
            s = idx * interval[d]
            s -= max(s + roi_size[d] - image_size[d], 0)
            starts.append(s)
        per_dim.append(starts)
    return np.asarray(list(itertools.product(*per_dim)), dtype=np.int64)


@functools.lru_cache(maxsize=None)
def gaussian_importance_map(roi_size: Tuple3,
                            sigma_scale: float = 0.125) -> np.ndarray:
    """Separable Gaussian blending weights over a window (fp32, max 1),
    centred at size // 2 with sigma = sigma_scale * size, clamped away from
    zero like MONAI's compute_importance_map."""
    axes = []
    for s in roi_size:
        x = np.arange(s, dtype=np.float64)
        axes.append(np.exp(-0.5 * ((x - s // 2) / (sigma_scale * s)) ** 2))
    g = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    g = g / g.max()
    g = np.maximum(g, max(g[g > 0].min(), 1e-3))
    return g.astype(np.float32)


def sliding_window_inference(
    inputs: torch.Tensor,
    affine: torch.Tensor,
    roi_size: Tuple3,
    sw_batch_size: int,
    predictor: Callable,
    n_classes: int,
    overlap: float = 0.25,
    mode: str = "constant",
    sigma_scale: float = 0.125,
    cval: float = 0.0,
) -> torch.Tensor:
    """inputs (B, D, H, W, C) -> blended logits (B, D, H, W, n_classes) fp32.

    ``predictor((windows (k, *roi, C), centers (k, 3), affine (k, 3)))``
    returns (k, *roi, n_classes) logits, k <= sw_batch_size (the last batch
    of a volume may be short). Volumes smaller than the roi are padded
    symmetrically with ``cval`` and cropped back."""
    b, d0, h0, w0, _ = inputs.shape
    roi = tuple(int(r) for r in roi_size)
    dev = inputs.device

    pads, image_size, starts, centers = _window_grid((d0, h0, w0), roi,
                                                     overlap)
    x = F.pad(inputs, (0, 0, *pads[2], *pads[1], *pads[0]), value=cval)
    centers = torch.from_numpy(centers).to(dev)
    imap = torch.from_numpy(_importance_map(roi, mode, sigma_scale)).to(
        dev)[None]  # (1, *roi)

    blends = []
    for bi in range(b):
        out = torch.zeros((n_classes,) + image_size, dtype=torch.float32,
                          device=dev)
        cnt = torch.zeros((1,) + image_size, dtype=torch.float32, device=dev)
        for i0 in range(0, len(starts), sw_batch_size):
            batch = starts[i0:i0 + sw_batch_size]
            k = len(batch)
            with profiling.span("sw.gather", windows=k):
                wins = torch.stack([x[bi, s0:s0 + roi[0], s1:s1 + roi[1],
                                      s2:s2 + roi[2]] for s0, s1, s2 in batch])
            with profiling.span("sw.predictor", windows=k):
                probs = predictor((wins, centers[i0:i0 + k],
                                   affine[bi].expand(k, 3)))
            with profiling.span("sw.blend", windows=k):
                probs = probs.float().permute(0, 4, 1, 2, 3)  # class-major
                for i, (s0, s1, s2) in enumerate(batch):
                    sl = (slice(None), slice(s0, s0 + roi[0]),
                          slice(s1, s1 + roi[1]), slice(s2, s2 + roi[2]))
                    out[sl] += imap * probs[i]
                    cnt[sl] += imap
        blends.append((out, cnt))
    with profiling.span("sw.normalise"):
        result = torch.stack([(o / c).permute(1, 2, 3, 0) for o, c in blends])
        return result[:, pads[0][0]:pads[0][0] + d0,
                      pads[1][0]:pads[1][0] + h0, pads[2][0]:pads[2][0] + w0]


def _importance_map(roi: Tuple3, mode: str, sigma_scale: float) -> np.ndarray:
    return (gaussian_importance_map(roi, sigma_scale) if mode == "gaussian"
            else np.ones(roi, np.float32))


def _window_grid(shape: Tuple3, roi: Tuple3, overlap: float):
    """(pads, padded image size, window starts (N, 3), normalised window
    centres (N, 3) fp32) of a volume of spatial ``shape``."""
    pads = []
    for i, dim in enumerate(shape):
        diff = max(roi[i] - dim, 0)
        pads.append((diff // 2, diff - diff // 2))
    image_size = tuple(max(shape[i], roi[i]) for i in range(3))
    starts = dense_patch_starts(image_size, roi,
                                scan_interval(image_size, roi, overlap))
    centers = np.stack([(starts[:, i] + roi[i] - roi[i] // 2) / image_size[i]
                        for i in range(3)], axis=1).astype(np.float32)
    return pads, image_size, starts, centers


def sliding_window_inference_sharded(
    inputs: torch.Tensor,
    affine: torch.Tensor,
    roi_size: Tuple3,
    predictor: Callable,
    n_classes: int,
    overlap: float = 0.25,
    mode: str = "gaussian",
    sigma_scale: float = 0.125,
    cval: float = 0.0,
    group=None,
) -> torch.Tensor:
    """Window-parallel inference of one volume over the ranks of ``group``
    (default: the world). inputs (1, D, H, W, C), every rank the same ->
    blended logits (1, D, H, W, n_classes) fp32 on every rank.

    The window list is padded with repeats of its last window to an equal
    count per rank; the repeats blend with weight 0. Rank r blends windows
    [r n, (r + 1) n) one at a time into a partial (output, count), and one
    all_reduce sums the partials before the divide, as the JAX package's
    ``shard_map`` + ``psum`` does."""
    import torch.distributed as dist

    if inputs.shape[0] != 1:
        raise ValueError("sharded inference stitches one volume")
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    roi = tuple(int(r) for r in roi_size)
    dev = inputs.device
    shape = tuple(inputs.shape[1:4])
    pads, image_size, starts, centers = _window_grid(shape, roi, overlap)
    x = F.pad(inputs[0], (0, 0, *pads[2], *pads[1], *pads[0]), value=cval)

    pad_n = (-len(starts)) % world
    starts = np.concatenate([starts, np.repeat(starts[-1:], pad_n, 0)])
    centers = np.concatenate([centers, np.repeat(centers[-1:], pad_n, 0)])
    valid = np.concatenate([np.ones(len(starts) - pad_n, np.float32),
                            np.zeros(pad_n, np.float32)])
    per = len(starts) // world
    mine = range(rank * per, (rank + 1) * per)

    imap = torch.from_numpy(_importance_map(roi, mode, sigma_scale)).to(
        dev)[None]
    out = torch.zeros((n_classes,) + image_size, dtype=torch.float32,
                      device=dev)
    cnt = torch.zeros((1,) + image_size, dtype=torch.float32, device=dev)
    for i in mine:
        s0, s1, s2 = (int(v) for v in starts[i])
        sl = (slice(None), slice(s0, s0 + roi[0]), slice(s1, s1 + roi[1]),
              slice(s2, s2 + roi[2]))
        with profiling.span("sw.gather", windows=1):
            model_in = (x[sl[1:]][None],
                        torch.from_numpy(centers[i:i + 1]).to(dev), affine)
        with profiling.span("sw.predictor", windows=1):
            prob = predictor(model_in)[0]
        with profiling.span("sw.blend", windows=1):
            wgt = imap * float(valid[i])
            out[sl] += wgt * prob.float().permute(3, 0, 1, 2)
            cnt[sl] += wgt
    dist.all_reduce(out, group=group)
    dist.all_reduce(cnt, group=group)
    with profiling.span("sw.normalise"):
        result = (out / cnt).permute(1, 2, 3, 0)
        return result[pads[0][0]:pads[0][0] + shape[0],
                      pads[1][0]:pads[1][0] + shape[1],
                      pads[2][0]:pads[2][0] + shape[2]][None]


def grouped_padded_volumes(loader, n_group: int, multiple: int, cval: float,
                           policy: str = "bucket"):
    """Group a Sample iterator into same-shaped padded stacks (the JAX
    package's grouping for its volume-parallel runner).

    Yields (vols (G, D', H', W', C) fp32, affines (G, 3) fp32, samples list,
    orig_shapes list) with G == n_group; a trailing partial group is filled
    by repeating its last volume (callers read the first len(samples)).

    ``bucket``: only volumes whose bucket-padded shapes match share a group,
    so each volume's logits are the one-device ones. ``sorted_max``: the
    volumes sorted by padded size, any n_group consecutive ones grouped and
    padded to the elementwise maximum of their buckets (full groups; a
    volume's window grid may then differ from its own bucket's)."""

    def make_group(items):
        samples = [s for s, _, _ in items]
        pads = [p for _, p, _ in items]
        origs = [o for _, _, o in items]
        while len(pads) < n_group:
            pads.append(pads[-1])
        vols = np.stack(pads).astype(np.float32)
        affs = np.stack([
            np.diag(s.original_affine)[:3].astype(np.float32)
            for s in (samples + [samples[-1]] * (n_group - len(samples)))])
        return vols, affs, samples, origs

    if policy == "sorted_max":
        items = []
        for sample in loader:
            orig = sample.image.shape[:3]
            bshape = tuple(orig[d] + (-orig[d]) % multiple for d in range(3))
            items.append((sample, bshape, orig))
        items.sort(key=lambda it: (int(np.prod(it[1])), it[1]))
        for i in range(0, len(items), n_group):
            chunk = items[i:i + n_group]
            gmax = tuple(max(b[d] for _, b, _ in chunk) for d in range(3))
            chunk = [
                (s, np.pad(s.image,
                           [(0, gmax[d] - s.image.shape[d]) for d in range(3)]
                           + [(0, 0)], constant_values=cval)
                 if s.image.shape[:3] != gmax else s.image, o)
                for s, _, o in chunk]
            yield make_group(chunk)
        return
    if policy != "bucket":
        raise ValueError(f"unknown grouping policy: {policy!r}")

    pending: dict = {}
    for sample in loader:
        padded, orig = bucket_pad(sample.image, multiple, cval)
        key = padded.shape
        pending.setdefault(key, []).append((sample, padded, orig))
        if len(pending[key]) == n_group:
            yield make_group(pending.pop(key))
    for key in list(pending):
        yield make_group(pending.pop(key))


def rank_volumes(loader, rank: int, world: int, multiple: int, cval: float,
                 policy: str = "bucket") -> Iterator:
    """This rank's volumes for volume-parallel prediction (the counterpart
    of the JAX package's ``jitted_sliding_window_sharded``: each rank runs
    the one-device :func:`sliding_window_inference` on every volume this
    yields, with no collective): yields (index in ``loader``, sample,
    padded volume (D', H', W', C), original shape).

    ``bucket`` (and any policy at world 1): volume i goes to rank i % world,
    padded to its own bucket, and only this rank's volumes are loaded
    (``loader`` an ``EvalLoader`` or a list of samples). Each volume's
    logits are then the one-device ones, which is all the JAX package's
    bucket grouping guarantees. ``sorted_max``: the ranks take the members
    of :func:`grouped_padded_volumes`' groups in rank order, so a volume is
    padded to its group's maximum as under the JAX package at the same
    device count (every rank loads every volume for the sort)."""
    items = getattr(loader, "ds", loader)
    if policy == "sorted_max" and world > 1:
        samples = [items[i] for i in range(len(items))]
        index = {id(s): i for i, s in enumerate(samples)}
        for vols, _, group, origs in grouped_padded_volumes(
                samples, world, multiple, cval, policy):
            if rank < len(group):
                yield index[id(group[rank])], group[rank], vols[rank], \
                    origs[rank]
        return
    if policy not in ("bucket", "sorted_max"):
        raise ValueError(f"unknown grouping policy: {policy!r}")
    for i in range(rank, len(items), world):
        sample = items[i]
        with profiling.span("sw.pad", unit=i) as sp:
            padded, orig = bucket_pad(sample.image, multiple, cval)
            sp.set(bytes=padded.nbytes)
        yield i, sample, padded, orig
