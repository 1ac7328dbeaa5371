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
from typing import Dict, Iterator, List, Sequence

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


class TrainLoader:
    """Random-crop batch iterator with an ordered worker pool.

    One epoch is one pass over the shuffled cached volumes in groups of
    ``n_images_per_batch`` (the last, short group is dropped; a dataset
    smaller than one group wraps around). Each batch draws from its own
    stream seeded (seed, epoch, batch), so the batches are bit-identical for
    any worker count."""

    def __init__(self, dataset: CachedVolumeDataset, cfg: Config,
                 seed: int = 0, prefetch: int = 2):
        self.ds, self.cfg = dataset, cfg
        self.seed, self.prefetch = seed, prefetch

    def steps_per_epoch(self) -> int:
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
        order = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch])).permutation(
                len(self.ds))
        n_batches = self.steps_per_epoch()
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
