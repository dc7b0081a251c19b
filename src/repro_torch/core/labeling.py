"""Instance labeling (paper Section 3, "Labeling Instances" + Algorithm 1).

A query's ordinal class is the minimal cutoff index whose MED is inside
the effectiveness envelope (MED <= tau), or c when none is.
Algorithm 1 turns the c-way problem into c binary training sets, and
``stratified_folds`` splits queries for cross-validation.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["envelope_labels", "multiclass_to_binary", "stratified_folds",
           "K_CUTOFFS", "RHO_FRACTIONS"]

#: the paper's 9 candidate-pool cutoffs
K_CUTOFFS = (20, 50, 100, 200, 500, 1000, 2000, 5000, 10000)

#: the paper's rho cutoffs as fractions of the stream (0.2%..100%)
RHO_FRACTIONS = (0.002, 0.004, 0.01, 0.02, 0.04, 0.1, 0.2, 0.4, 1.0)


def envelope_labels(med, tau: float) -> torch.Tensor:
    """Ordinal class per query.  med: (Q, c) MED at each cutoff ->
    (Q,) int32 in [0, c]: index of the minimal in-envelope cutoff, or c."""
    med = torch.as_tensor(med)
    ok = med <= tau
    # first True: argmax over an int view (torch's argmax of equal
    # maxima is the first one)
    first = ok.to(torch.int32).argmax(dim=1)
    none = ~ok.any(dim=1)
    return torch.where(none, torch.full_like(first, med.shape[1]),
                       first).to(torch.int32)


def multiclass_to_binary(labels: np.ndarray, n_cutoffs: int) -> np.ndarray:
    """Algorithm 1 (MULTICLASSTOBINARY): (c, Q) binary label sets, row i
    is 0 where class <= i else 1."""
    labels = np.asarray(labels)
    i = np.arange(n_cutoffs)[:, None]
    return (labels[None, :] > i).astype(np.int64)


def stratified_folds(labels: np.ndarray, n_folds: int = 10,
                     seed: int = 13) -> np.ndarray:
    """Per-query fold id, stratified by class (Weka StratifiedRemoveFolds
    stand-in): within each class, shuffled round-robin assignment."""
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    fold = np.zeros(len(labels), np.int32)
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        fold[idx] = np.arange(len(idx)) % n_folds
    return fold
