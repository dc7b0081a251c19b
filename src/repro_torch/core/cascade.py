"""LRCascade (paper Algorithm 2 + Figure 5).

A left-to-right chain of c binary classifiers, one per cutoff boundary.
Node i answers "does cutoff i suffice?" (class 0); a query exits at the
first node whose class-0 probability exceeds its threshold, else takes
the maximal class c.

  * ``predict_sequential``: the literal Algorithm 2 for one query, a
    host loop that exits at the first firing node.
  * ``predict_batched``: every node for the whole batch, then the first
    firing node.  Identical outputs (tested).

Nodes are forests (fitted on the host, evaluated on the tables' device)
or MLPs (trained on the device).  ``tune_thresholds`` picks per-node
thresholds on a validation fold.  ``train_cascade(warm=, warm_frac=)``
warm-starts the online loop's forest refits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import forest as forest_lib
from repro_torch.core import labeling
from repro_torch.core import mlp as mlp_lib
from repro_torch.device import resolve_device
from repro_torch.models.layers import to_device
from repro_torch.tree import map_tree

__all__ = ["Cascade", "train_cascade", "predict_batched",
           "predict_sequential", "tune_thresholds",
           "proba0_from_params", "classes_from_proba", "place_node_params"]


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


def _node_proba(kind: str, params, x: torch.Tensor,
                max_depth: int) -> torch.Tensor:
    if kind == "forest":
        return forest_lib.forest_predict_proba(params, x, max_depth)
    return mlp_lib.mlp_predict_proba(params, x)


def proba0_from_params(kind: str, node_params, x: torch.Tensor,
                       max_depth: int) -> torch.Tensor:
    """(B, c) class-0 probabilities from an explicit per-node parameter
    list (the form the server keeps swappable)."""
    cols = [_node_proba(kind, p, x, max_depth)[:, 0] for p in node_params]
    return torch.stack(cols, dim=1)


def place_node_params(kind: str, node_params, max_depth: int,
                      device) -> list:
    """Per-node parameter trees (forest tables or MLP states) as tensors
    on ``device``; forest tables padded to the depth-derived capacity
    (``forest.node_capacity``), so every same-depth retrain has the same
    shapes.  Padding is inert: inference is bit-identical."""
    out = [map_tree(lambda v: torch.as_tensor(v).to(device), p)
           for p in node_params]
    if kind != "forest":
        return out
    cap = forest_lib.node_capacity(max_depth)
    return [forest_lib.pad_forest_params(p, cap) for p in out]


def classes_from_proba(p0: torch.Tensor, t) -> torch.Tensor:
    """First node whose class-0 probability clears its threshold; ``t``
    is a Python number, or a float32 tensor on ``p0``'s device (a scalar
    or a per-node vector), so a captured predict reads no host data.  No
    firing node -> class c."""
    c = p0.shape[1]
    fire = p0 > t
    first = fire.to(torch.int32).argmax(dim=1)
    none = ~fire.any(dim=1)
    return torch.where(none, torch.full_like(first, c),
                       first).to(torch.int32)


@dataclass
class Cascade:
    """c binary nodes; node i was trained on Algorithm 1's set B_i."""

    kind: str                      # "forest" | "mlp"
    nodes: list                    # per-node host models
    node_params: list              # per-node trees of tensors
    max_depth: int = 0
    n_cutoffs: int = 9

    def proba0(self, x: torch.Tensor) -> torch.Tensor:
        """(B, c) probability that cutoff i suffices, for all nodes."""
        _check_features(x)
        return proba0_from_params(self.kind, self.node_params, x,
                                  self.max_depth)

    @property
    def device(self) -> torch.device:
        """The device of the node parameters."""
        p = self.node_params[0]
        return (p["feature"] if self.kind == "forest" else p["mean"]).device

    def to(self, device) -> "Cascade":
        """The same cascade with its node parameters on ``device``."""
        params = to_device(self.node_params, resolve_device(device))
        return Cascade(self.kind, self.nodes, params, self.max_depth,
                       self.n_cutoffs)


def train_cascade(x: np.ndarray, labels: np.ndarray, *, n_cutoffs: int,
                  kind: str = "forest", seed: int = 0,
                  forest_kwargs: dict | None = None,
                  mlp_kwargs: dict | None = None,
                  warm: Cascade | None = None, warm_frac: float = 0.0,
                  device=None) -> Cascade:
    """Train one binary node per cutoff boundary (Algorithm 1 data).
    Forests are fitted on the host and their tables go to ``device``;
    MLPs train on ``device``.

    ``warm``/``warm_frac`` warm-start forest refits: node i carries
    ``warm_frac`` of its trees verbatim from ``warm.nodes[i]`` (see
    ``forest.train_forest``).  Ignored for mlp nodes."""
    if kind not in ("forest", "mlp"):
        raise ValueError(f"unknown node kind {kind!r}")
    dev = resolve_device(device)
    binary = labeling.multiclass_to_binary(labels, n_cutoffs)
    if warm is not None and warm_frac > 0.0 and kind == "forest":
        if warm.kind != "forest" or warm.n_cutoffs != n_cutoffs:
            raise ValueError(
                f"warm cascade ({warm.kind}, {warm.n_cutoffs} cutoffs) "
                f"cannot warm-start a forest cascade with {n_cutoffs}")
    else:
        warm = None
    nodes, params = [], []
    depth = 0
    for i in range(n_cutoffs):
        if kind == "forest":
            kw = dict(n_trees=25, max_depth=8, seed=seed + i)
            kw.update(forest_kwargs or {})
            if warm is not None:
                kw.update(warm=warm.nodes[i], warm_frac=warm_frac)
            node = forest_lib.train_forest(x, binary[i], n_classes=2, **kw)
            depth = node.max_depth
        else:
            kw = dict(seed=seed + i)
            kw.update(mlp_kwargs or {})
            node = mlp_lib.train_mlp(x, binary[i], n_classes=2, device=dev,
                                     **kw)
        nodes.append(node)
        params.append(node.as_torch(dev))
    return Cascade(kind=kind, nodes=nodes, node_params=params,
                   max_depth=depth, n_cutoffs=n_cutoffs)


def predict_batched(cascade: Cascade, x: torch.Tensor, t) -> torch.Tensor:
    """Vectorized Algorithm 2: (B,) predicted cutoff index in [0, c].

    ``t`` is a scalar confidence threshold or a per-node vector of c
    thresholds (the paper's "variable cutoff thresholds" extension)."""
    p0 = cascade.proba0(x)
    return classes_from_proba(p0, torch.as_tensor(
        t, dtype=torch.float32, device=p0.device))


def tune_thresholds(cascade: Cascade, x: np.ndarray, med_table: np.ndarray,
                    cutoff_values, tau: float,
                    grid=(0.6, 0.7, 0.75, 0.8, 0.85, 0.9),
                    min_compliance: float = 0.95) -> np.ndarray:
    """Per-node threshold tuning on a validation fold (paper section 5:
    "initial efforts towards variable cutoff thresholds").

    Greedy left-to-right: for node i, pick the smallest threshold whose
    *marginal exits* stay ``min_compliance`` inside the envelope.  The
    probabilities come from the cascade's device; the comparisons with
    the grid's Python floats stay in numpy, as in the reference."""
    c = cascade.n_cutoffs
    xt = torch.tensor(x, dtype=torch.float32, device=cascade.device)
    p0 = cascade.proba0(xt).cpu().numpy()        # (B, c)
    thresholds = np.full(c, grid[-1], np.float32)
    exited = np.zeros(len(x), bool)
    for i in range(c):
        best = grid[-1]
        for t in grid:                           # ascending
            exits = (~exited) & (p0[:, i] > t)
            if exits.sum() == 0:
                continue
            ok = (med_table[exits, i] <= tau).mean()
            if ok >= min_compliance:
                best = t
                break
        thresholds[i] = best
        exited |= (~exited) & (p0[:, i] > best)
    return thresholds


def predict_sequential(cascade: Cascade, x_row: np.ndarray,
                       t: float) -> int:
    """Literal Algorithm 2 for a single query: evaluate nodes left to
    right on the cascade's device and exit at the first whose class-0
    probability exceeds ``t`` (one host read per node)."""
    xr = torch.tensor(x_row, dtype=torch.float32,
                      device=cascade.device)[None, :]
    for i, p in enumerate(cascade.node_params):
        pr = _node_proba(cascade.kind, p, xr, cascade.max_depth)
        if float(pr[0, 0]) > t:                  # predicts 0 with Pr > t
            return i
    return cascade.n_cutoffs
