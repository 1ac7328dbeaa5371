"""Decathlon datalists, cross-validation splits, per-host partitioning.

Reference: the reference's dataset module + MONAI load_decathlon_datalist /
partition_dataset semantics, and utils/misc.py:338-418 datalist persistence.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from medicalsemseg_tpu_torch.config import Config


def load_decathlon_datalist(json_path: str, data_list_key: str = "training",
                            base_dir: Optional[str] = None) -> List[Dict]:
    """MONAI load_decathlon_datalist: resolve relative paths against the json's
    directory; plain-string test entries become {'image': path}."""
    with open(json_path) as f:
        spec = json.load(f)
    if data_list_key not in spec:
        raise ValueError(f"key {data_list_key!r} not in {json_path}")
    base = base_dir or os.path.dirname(json_path)
    out = []
    for item in spec[data_list_key]:
        if isinstance(item, str):
            item = {"image": item}
        entry = dict(item)
        for k in ("image", "label"):
            if k in entry and isinstance(entry[k], str):
                entry[k] = os.path.join(base, entry[k])
        out.append(entry)
    return out


def check_json_for_key(json_path: str, key: str) -> bool:
    with open(json_path) as f:
        return key in json.load(f)


def cv_split(files: List[Dict], fold: int, max_folds: int,
             seed: int) -> Tuple[List[Dict], List[Dict]]:
    """Seeded-shuffle K-fold split:
    random.Random(seed).shuffle then np.array_split; fold -> val, rest train."""
    files = list(files)
    random.Random(seed).shuffle(files)
    splits = np.array_split(np.asarray(files, dtype=object), max_folds)
    val = list(splits[fold])
    train = [f for i, s in enumerate(splits) if i != fold for f in s]
    return train, val


def partition_dataset(data: Sequence, num_partitions: int, shuffle: bool = False,
                      seed: int = 0, even_divisible: bool = True) -> List[List]:
    """MONAI partition_dataset semantics:
    round-robin-free contiguous split; with even_divisible the list is padded
    by wrapping so every partition has equal length."""
    data = list(data)
    if shuffle:
        random.Random(seed).shuffle(data)
    n = len(data)
    if even_divisible and n % num_partitions != 0:
        pad = num_partitions - n % num_partitions
        data = data + data[:pad]
        n = len(data)
    sizes = [n // num_partitions] * num_partitions
    for i in range(n % num_partitions):
        sizes[i] += 1
    out, idx = [], 0
    for s in sizes:
        out.append(data[idx:idx + s])
        idx += s
    return out


def save_decathlon_datalist(src_json: str, train_files: Sequence[Dict],
                            val_files: Sequence[Dict],
                            out_dir: Optional[str]) -> None:
    """Persist the materialized CV split next to the logs
    (reference: utils/misc.py save_decathlon_datalist)."""
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    payload = {
        "source": src_json,
        "training": [dict(f) for f in train_files],
        "validation": [dict(f) for f in val_files],
    }
    with open(os.path.join(out_dir, "dataset_cv_split.json"), "w") as f:
        json.dump(payload, f, indent=2)


def build_cv_file_lists(cfg: Config) -> Tuple[List[Dict], List[Dict]]:
    """Training/validation file lists for the current fold: pre-split json wins; otherwise
    seeded CV split of the 'training' section."""
    data_json = os.path.join(cfg.data_path, cfg.task, cfg.json_list)
    if check_json_for_key(data_json, "validation"):
        train = load_decathlon_datalist(data_json, "training")
        val = load_decathlon_datalist(data_json, "validation")
    else:
        files = load_decathlon_datalist(data_json, "training")
        train, val = cv_split(files, cfg.cv_fold, cfg.cv_max_folds, cfg.seed)
    return train, val
