"""LRCascade (paper Algorithm 2 + Figure 5), forest nodes.

A left-to-right chain of c binary classifiers, one per cutoff boundary.
Node i answers "does cutoff i suffice?" (class 0); a query exits at the
first node whose class-0 probability exceeds its threshold, else takes
the maximal class c.  ``predict_batched`` evaluates every node for the
whole batch and takes the first firing node.  The JAX package's ``mlp``
node kind is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import forest as forest_lib
from repro_torch.core import labeling
from repro_torch.device import resolve_device

__all__ = ["Cascade", "train_cascade", "predict_batched",
           "proba0_from_params", "classes_from_proba"]


def _check_features(x: torch.Tensor) -> None:
    """Reject empty or NaN feature batches: NaN compares False, so every
    node would route left and emit confident nonsense classes."""
    if x.dim() != 2 or 0 in x.shape:
        raise ValueError(
            "feature batch must be a non-empty (B, F) matrix, got shape "
            f"{tuple(x.shape)}")
    if bool(torch.isnan(x).any()):
        raise ValueError(
            "feature batch contains NaN -- refusing to predict from "
            "corrupt features")


def _check_kind(kind: str) -> None:
    if kind != "forest":
        raise ValueError(f"node kind {kind!r} is not ported (forest only)")


def proba0_from_params(kind: str, node_params, x: torch.Tensor,
                       max_depth: int) -> torch.Tensor:
    """(B, c) class-0 probabilities from an explicit per-node parameter
    list (the form the server keeps swappable)."""
    _check_kind(kind)
    cols = [forest_lib.forest_predict_proba(p, x, max_depth)[:, 0]
            for p in node_params]
    return torch.stack(cols, dim=1)


def classes_from_proba(p0: torch.Tensor, t) -> torch.Tensor:
    """First node whose class-0 probability clears its threshold; ``t``
    is a scalar or a per-node vector.  No firing node -> class c."""
    c = p0.shape[1]
    tv = torch.as_tensor(t, dtype=torch.float32, device=p0.device)
    fire = p0 > tv.expand(c)[None, :]
    first = fire.to(torch.int32).argmax(dim=1)
    none = ~fire.any(dim=1)
    return torch.where(none, torch.full_like(first, c),
                       first).to(torch.int32)


@dataclass
class Cascade:
    """c binary nodes; node i was trained on Algorithm 1's set B_i."""

    kind: str                      # "forest"
    nodes: list                    # per-node host models (Forest)
    node_params: list              # per-node dicts of tensors
    max_depth: int = 0
    n_cutoffs: int = 9

    def proba0(self, x: torch.Tensor) -> torch.Tensor:
        """(B, c) probability that cutoff i suffices, for all nodes."""
        _check_features(x)
        return proba0_from_params(self.kind, self.node_params, x,
                                  self.max_depth)

    def to(self, device) -> "Cascade":
        """The same cascade with its node tables on ``device``."""
        dev = resolve_device(device)
        params = [{k: v.to(dev) for k, v in p.items()}
                  for p in self.node_params]
        return Cascade(self.kind, self.nodes, params, self.max_depth,
                       self.n_cutoffs)


def train_cascade(x: np.ndarray, labels: np.ndarray, *, n_cutoffs: int,
                  kind: str = "forest", seed: int = 0,
                  forest_kwargs: dict | None = None,
                  device=None) -> Cascade:
    """Train one binary node per cutoff boundary (Algorithm 1 data) on
    the host; the node tables go to ``device``."""
    _check_kind(kind)
    dev = resolve_device(device)
    binary = labeling.multiclass_to_binary(labels, n_cutoffs)
    nodes, params = [], []
    depth = 0
    for i in range(n_cutoffs):
        kw = dict(n_trees=25, max_depth=8, seed=seed + i)
        kw.update(forest_kwargs or {})
        f = forest_lib.train_forest(x, binary[i], n_classes=2, **kw)
        nodes.append(f)
        params.append(f.as_torch(dev))
        depth = f.max_depth
    return Cascade(kind=kind, nodes=nodes, node_params=params,
                   max_depth=depth, n_cutoffs=n_cutoffs)


def predict_batched(cascade: Cascade, x: torch.Tensor, t) -> torch.Tensor:
    """Vectorized Algorithm 2: (B,) predicted cutoff index in [0, c]."""
    return classes_from_proba(cascade.proba0(x), t)
