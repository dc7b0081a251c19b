"""Baselines the paper compares against (Section 3/4 + Figure 4).

  * Fixed cutoff: one global parameter for every query, the tradeoff
    horizon (``tradeoff.horizon``).
  * MultiLabel: a plain multiclass classifier over the ordinal classes.
  * MetaCost (Domingos 1999): bagged probability estimates relabel the
    training set under the Figure-4 cost matrix (under-predictions
    penalized, over-predictions free), then an ordinary multiclass
    classifier is trained on the relabeled data.
  * Oracle: the true minimal in-envelope cutoff.

Forests are fitted on the host (``forest.train_forest``, the same tables
as the JAX package's from the same seed) and evaluated on a device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import forest as forest_lib
from repro_torch.device import resolve_device

__all__ = [
    "cost_matrix",
    "train_multilabel",
    "predict_multilabel",
    "train_metacost",
    "oracle_predict",
]


def cost_matrix(n_classes: int, over_cost: float = 0.0,
                under_base: float = 2.0) -> np.ndarray:
    """Figure-4-style cost matrix C[true, pred].

    Over-predictions (pred > true) cost ``over_cost`` (paper: 0; they only
    cost efficiency).  Under-predictions (pred < true) are penalized
    super-linearly and more heavily for high true classes."""
    c = np.zeros((n_classes, n_classes))
    for true in range(n_classes):
        for pred in range(n_classes):
            if pred < true:
                c[true, pred] = under_base * (true - pred) * (1 + true)
            elif pred > true:
                c[true, pred] = over_cost * (pred - true)
    return c


def train_multilabel(x: np.ndarray, labels: np.ndarray, n_classes: int,
                     seed: int = 0, **forest_kwargs) -> forest_lib.Forest:
    kw = dict(n_trees=40, max_depth=10)
    kw.update(forest_kwargs)
    return forest_lib.train_forest(x, labels, n_classes=n_classes,
                                   seed=seed, **kw)


def predict_multilabel(f: forest_lib.Forest, x: torch.Tensor) -> torch.Tensor:
    """(B,) int32 class of highest averaged leaf probability, on
    ``x``'s device (ties to the lower class)."""
    p = forest_lib.forest_predict_proba(f.as_torch(x.device), x, f.max_depth)
    return torch.argmax(p, dim=1).to(torch.int32)


def train_metacost(x: np.ndarray, labels: np.ndarray, n_classes: int,
                   cost: np.ndarray | None = None, n_bags: int = 10,
                   seed: int = 0, device=None,
                   **forest_kwargs) -> forest_lib.Forest:
    """MetaCost: relabel each instance with argmin_j sum_i P(i|x) C[i, j],
    where P comes from bagged forests (evaluated on ``device``, summed in
    float64 on the host), then train on the relabeled set."""
    if cost is None:
        cost = cost_matrix(n_classes)
    xt = torch.tensor(x, dtype=torch.float32, device=resolve_device(device))
    rng = np.random.default_rng(seed)
    probs = np.zeros((len(labels), n_classes))
    for b in range(n_bags):
        boot = rng.integers(0, len(labels), size=len(labels))
        f = forest_lib.train_forest(x[boot], labels[boot],
                                    n_classes=n_classes, n_trees=10,
                                    max_depth=8, seed=seed * 131 + b)
        probs += forest_lib.forest_predict_proba(
            f.as_torch(xt.device), xt, f.max_depth).cpu().numpy()
    probs /= n_bags
    relabel = np.argmin(probs @ cost, axis=1)
    return train_multilabel(x, relabel, n_classes, seed=seed + 7,
                            **forest_kwargs)


def oracle_predict(labels: np.ndarray) -> np.ndarray:
    """The perfect classifier: the true minimal in-envelope class."""
    return np.asarray(labels)
