"""K-fold majority-vote ensembling (counterpart of
medicalsemseg_tpu/infer/ensemble.py).

Foreground classes get one vote per fold that predicted them; background
counts its votes too but starts at +1, so ties go to background.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def majority_vote(fold_labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(K, *spatial) integer fold predictions -> (*spatial,) int32 labels, on
    the tensor's device (argmax takes the first of equal counts)."""
    votes = F.one_hot(fold_labels.long(), n_classes).sum(0)
    votes[..., 0] += 1
    return votes.argmax(-1).to(torch.int32)


def majority_vote_np(fold_labels: np.ndarray, n_classes: int) -> np.ndarray:
    """The same vote in NumPy, for the CLI on host-resident volumes."""
    votes = np.zeros((n_classes,) + fold_labels.shape[1:], np.int32)
    for c in range(n_classes):
        votes[c] = (fold_labels == c).sum(axis=0)
    votes[0] += 1
    return votes.argmax(axis=0).astype(np.int32)
