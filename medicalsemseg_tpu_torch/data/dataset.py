"""Cached datasets and batch loaders (counterpart of
medicalsemseg_tpu/data/dataset.py).

The deterministic transform prefix runs once per volume into a host-memory
cache; each training step samples random crops from the cache and collates a
static-shaped channels-last numpy batch. A thread pool prepares the next
batches while the card computes. The batch is ``n_images_per_batch`` volumes
times ``t_n_patches_per_image`` crops.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from medicalsemseg_tpu_torch.config import Config
from medicalsemseg_tpu_torch.data.preprocess import (
    Sample,
    load_and_preprocess,
    sample_training_crops,
)


def _pool_size(cfg: Config, mode: str) -> int:
    """--n_workers_train / --n_workers_val. Threads, not processes: the hot
    loader work (zlib inflate, NumPy slicing, the native resampler) releases
    the interpreter lock."""
    n = cfg.n_workers_train if mode == "train" else cfg.n_workers_val
    return max(int(n), 1)


class CachedVolumeDataset:
    """Preprocessed volumes; the first ``cache_rate`` share is kept in host
    memory (built on a thread pool), the rest is preprocessed on access."""

    def __init__(self, files: Sequence[Dict], cfg: Config,
                 cache_rate: float = 1.0, mode: str = "test"):
        self.files = list(files)
        self.cfg, self.mode = cfg, mode
        n_cache = int(len(self.files) * cache_rate)
        workers = min(_pool_size(cfg, mode), max(n_cache, 1))
        if workers > 1 and n_cache > 1:
            with cf.ThreadPoolExecutor(workers) as pool:
                loaded = list(pool.map(self._load, range(n_cache)))
        else:
            loaded = [self._load(i) for i in range(n_cache)]
        self._cache: Dict[int, Sample] = dict(enumerate(loaded))

    def _load(self, idx: int) -> Sample:
        f = self.files[idx]
        return load_and_preprocess(f["image"], f.get("label"), self.cfg,
                                   mode=self.mode)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Sample:
        return self._cache[idx] if idx in self._cache else self._load(idx)


def _collate(crops: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([c[k] for c in crops])
            for k in crops[0] if crops[0][k] is not None}


def epoch_order(rng: np.random.Generator, n: int, length: int) -> np.ndarray:
    """A permutation of range(n) drawn from ``rng``, followed by further
    ones until it holds at least ``length`` entries."""
    order = rng.permutation(n)
    while n and len(order) < length:
        order = np.concatenate([order, rng.permutation(n)])
    return order


def rank_share(cfg: Config, dp: int) -> Config:
    """This rank's loader settings when dp ranks split the global batch b =
    n_images_per_batch x t_n_patches_per_image: n_images / g volumes x
    patches g / dp crops each, g = gcd(n_images, dp), which is b / dp
    crops (dp divides b)."""
    import dataclasses
    import math

    g = math.gcd(cfg.n_images_per_batch, dp)
    return dataclasses.replace(
        cfg, n_images_per_batch=cfg.n_images_per_batch // g,
        t_n_patches_per_image=cfg.t_n_patches_per_image * g // dp)


class TrainLoader:
    """Random-crop batch iterator with an ordered worker pool.

    One epoch is one pass over the shuffled cached volumes in groups of
    ``n_images_per_batch`` (the last, short group is dropped; a dataset
    smaller than one group wraps around). Each batch draws from its own
    stream seeded (seed, epoch, batch), so the batches are bit-identical for
    any worker count. ``steps`` fixes the steps of an epoch (a data-parallel
    rank takes the whole run's count): the order then runs on through more
    permutations where one is too short."""

    def __init__(self, dataset: CachedVolumeDataset, cfg: Config,
                 seed: int = 0, prefetch: int = 2,
                 steps: Optional[int] = None):
        self.ds, self.cfg = dataset, cfg
        self.seed, self.prefetch, self.steps = seed, prefetch, steps

    def steps_per_epoch(self) -> int:
        if self.steps is not None:
            return self.steps
        return max(len(self.ds) // self.cfg.n_images_per_batch, 1)

    def _make_batch(self, order: np.ndarray, epoch: int, b: int):
        nb = self.cfg.n_images_per_batch
        idxs = order[b * nb:(b + 1) * nb]
        if len(idxs) < nb:  # wrap for tiny datasets
            idxs = np.concatenate([idxs, order[:nb - len(idxs)]])
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, b]))
        crops = []
        for i in idxs:
            crops.extend(sample_training_crops(self.ds[int(i)], self.cfg, rng))
        return _collate(crops)

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        n_batches = self.steps_per_epoch()
        order = epoch_order(
            np.random.default_rng(np.random.SeedSequence([self.seed, epoch])),
            len(self.ds),
            0 if self.steps is None else n_batches * self.cfg.n_images_per_batch)
        workers = _pool_size(self.cfg, self.ds.mode)
        # ordered bounded prefetch: workers + prefetch batches in flight,
        # always yielded in batch order
        with cf.ThreadPoolExecutor(workers) as pool:
            pending = [pool.submit(self._make_batch, order, epoch, b)
                       for b in range(min(workers + self.prefetch, n_batches))]
            next_submit = len(pending)
            for b in range(n_batches):
                batch = pending[b].result()
                pending[b] = None  # free the batch once consumed
                if next_submit < n_batches:
                    pending.append(pool.submit(self._make_batch, order,
                                               epoch, next_submit))
                    next_submit += 1
                yield batch


class EvalLoader:
    """Whole-volume iterator for validation and prediction (batch size 1)."""

    def __init__(self, dataset: CachedVolumeDataset):
        self.ds = dataset

    def __len__(self) -> int:
        return len(self.ds)

    def __iter__(self) -> Iterator[Sample]:
        for i in range(len(self.ds)):
            yield self.ds[i]
