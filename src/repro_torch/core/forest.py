"""Random forests: host numpy training, torch inference.

Training is a host-side histogram-greedy split search (a numpy copy of
the JAX package's, so the same seed gives identical tables).  Inference
runs over flattened tree tables held in a plain dict of tensors:

    feature[t, n], thresh[t, n], left[t, n], right[t, n], leaf[t, n, C]

as ``max_depth + 1`` rounds of gathers over (batch x trees).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Forest", "train_forest", "forest_predict_proba",
           "node_capacity", "pad_forest_params"]

_TABLES = ("feature", "thresh", "left", "right", "leaf")


@dataclass
class Forest:
    feature: np.ndarray   # (T, N) int32; -1 at leaves
    thresh: np.ndarray    # (T, N) float32
    left: np.ndarray      # (T, N) int32  (self-loop at leaves)
    right: np.ndarray     # (T, N) int32
    leaf: np.ndarray      # (T, N, C) float32 class probabilities
    max_depth: int
    n_classes: int

    def as_torch(self, device) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(getattr(self, k)))
                .to(device) for k in _TABLES}


def _gini_gain(hist_l: np.ndarray, hist_r: np.ndarray) -> np.ndarray:
    """Gini impurity decrease for every (bin-threshold) split."""
    nl = hist_l.sum(-1)
    nr = hist_r.sum(-1)
    n = nl + nr
    with np.errstate(divide="ignore", invalid="ignore"):
        gl = 1.0 - ((hist_l / np.maximum(nl[:, None], 1)) ** 2).sum(-1)
        gr = 1.0 - ((hist_r / np.maximum(nr[:, None], 1)) ** 2).sum(-1)
    tot = hist_l + hist_r
    gp = 1.0 - ((tot / np.maximum(n[:, None], 1)) ** 2).sum(-1)
    gain = gp - (nl / np.maximum(n, 1)) * gl - (nr / np.maximum(n, 1)) * gr
    gain[(nl == 0) | (nr == 0)] = -1.0
    return gain


def _fit_tree(xb: np.ndarray, y: np.ndarray, edges: np.ndarray,
              n_classes: int, rng: np.random.Generator, max_depth: int,
              feat_frac: float, min_leaf: int):
    """Grow one tree on pre-binned features xb (n, F)."""
    n, F = xb.shape
    bins = edges.shape[1] + 1
    m = max(1, int(round(feat_frac * F)))
    nodes: list[dict] = []

    def mk_leaf(idx):
        hist = np.bincount(y[idx], minlength=n_classes).astype(np.float64)
        p = hist / max(hist.sum(), 1.0)
        nodes.append({"feature": -1, "thresh": 0.0, "left": 0, "right": 0,
                      "leaf": p})
        nid = len(nodes) - 1
        nodes[nid]["left"] = nodes[nid]["right"] = nid
        return nid

    def grow(idx, depth):
        if depth >= max_depth or len(idx) < 2 * min_leaf or \
                len(np.unique(y[idx])) == 1:
            return mk_leaf(idx)
        feats = rng.choice(F, size=m, replace=False)
        best = (-1.0, None, None)
        for f in feats:
            xv = xb[idx, f]
            h = np.zeros((bins, n_classes))
            np.add.at(h, (xv, y[idx]), 1.0)
            cum = np.cumsum(h, axis=0)          # counts with bin <= b
            hist_l = cum[:-1]
            hist_r = cum[-1][None, :] - hist_l
            gain = _gini_gain(hist_l, hist_r)
            b = int(np.argmax(gain))
            if gain[b] > best[0]:
                best = (float(gain[b]), int(f), b)
        if best[1] is None or best[0] <= 1e-12:
            return mk_leaf(idx)
        _, f, b = best
        go_l = xb[idx, f] <= b
        li, ri = idx[go_l], idx[~go_l]
        if len(li) < min_leaf or len(ri) < min_leaf:
            return mk_leaf(idx)
        nid = len(nodes)
        nodes.append({"feature": f, "thresh": float(edges[f, b]),
                      "left": -1, "right": -1,
                      "leaf": np.zeros(n_classes)})
        nodes[nid]["left"] = grow(li, depth + 1)
        nodes[nid]["right"] = grow(ri, depth + 1)
        return nid

    grow(np.arange(n), 0)          # the root is always node 0
    return nodes


def train_forest(x: np.ndarray, y: np.ndarray, *, n_classes: int,
                 n_trees: int = 30, max_depth: int = 8, bins: int = 32,
                 feat_frac: float = 0.3, min_leaf: int = 8,
                 seed: int = 0, warm: Forest | None = None,
                 warm_frac: float = 0.0) -> Forest:
    """Bootstrap-aggregated trees over quantile-binned features.

    ``warm``/``warm_frac`` warm-start a refit: the first
    ``round(warm_frac * n_trees)`` trees are carried verbatim from
    ``warm`` and only the remainder is grown on the new data.  The
    carried forest must share ``max_depth`` and ``n_classes``, so the
    combined tables stay pad-compatible with the hot-swap template."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int64)
    n, F = x.shape
    n_carry = 0
    if warm is not None and warm_frac > 0.0:
        if warm.max_depth != max_depth or warm.n_classes != n_classes:
            raise ValueError(
                f"warm forest (depth {warm.max_depth}, "
                f"{warm.n_classes} classes) is not swap-compatible with "
                f"depth {max_depth} / {n_classes} classes")
        n_carry = min(n_trees, warm.feature.shape[0],
                      int(round(warm_frac * n_trees)))
    qs = np.linspace(0, 1, bins + 1)[1:-1]
    edges = np.quantile(x, qs, axis=0).T.astype(np.float32)   # (F, bins-1)
    # de-duplicate degenerate edges to keep searchsorted monotone
    edges = np.maximum.accumulate(edges + np.arange(bins - 1) * 1e-12, axis=1)
    xb = np.stack([np.searchsorted(edges[f], x[:, f], side="right")
                   for f in range(F)], axis=1).astype(np.int64)

    rng = np.random.default_rng(seed)
    all_nodes = []
    for _ in range(n_trees - n_carry):
        boot = rng.integers(0, n, size=n)
        all_nodes.append(_fit_tree(xb[boot], y[boot], edges, n_classes, rng,
                                   max_depth, feat_frac, min_leaf))
    n_max = max((len(t) for t in all_nodes), default=1)
    if n_carry:
        n_max = max(n_max, warm.feature.shape[1])
    T = n_trees
    feature = np.full((T, n_max), -1, np.int32)
    thresh = np.zeros((T, n_max), np.float32)
    left = np.zeros((T, n_max), np.int32)
    right = np.zeros((T, n_max), np.int32)
    leaf = np.zeros((T, n_max, n_classes), np.float32)
    leaf[:, :, 0] = 1.0
    if n_carry:
        w = warm.feature.shape[1]
        for name, table in (("feature", feature), ("thresh", thresh),
                            ("left", left), ("right", right),
                            ("leaf", leaf)):
            table[:n_carry, :w] = getattr(warm, name)[:n_carry]
    for t, tree in enumerate(all_nodes, start=n_carry):
        for i, nd in enumerate(tree):
            feature[t, i] = nd["feature"]
            thresh[t, i] = nd["thresh"]
            left[t, i] = nd["left"]
            right[t, i] = nd["right"]
            leaf[t, i] = nd["leaf"]
    return Forest(feature, thresh, left, right, leaf, max_depth, n_classes)


def node_capacity(max_depth: int) -> int:
    """Fixed node-table capacity: a tree grown to ``max_depth`` has at
    most 2^(d+1) - 1 nodes, so every same-depth retrain pads to the same
    shapes."""
    return 2 ** (max_depth + 1)


def pad_forest_params(params: dict, n_nodes: int) -> dict:
    """Pad flattened tree tables to a fixed node capacity.

    Padded nodes are unreachable, and inert anyway (self-looping leaves
    predicting class 0), so inference is bit-identical to the unpadded
    tables.  Raises when the tables already exceed the capacity."""
    feature = params["feature"]
    t, cur = feature.shape
    if cur > n_nodes:
        raise ValueError(
            f"forest has {cur} nodes per tree, more than the swap "
            f"capacity {n_nodes}; retrain with the template's max_depth")
    if cur == n_nodes:
        return dict(params)
    pad = n_nodes - cur
    dev = feature.device
    self_loop = torch.arange(cur, n_nodes, dtype=torch.int32,
                             device=dev).expand(t, pad)
    leaf = params["leaf"]
    leaf_pad = torch.zeros((t, pad, leaf.shape[-1]), dtype=leaf.dtype,
                           device=dev)
    leaf_pad[..., 0] = 1.0
    return {
        "feature": torch.nn.functional.pad(feature, (0, pad), value=-1),
        "thresh": torch.nn.functional.pad(params["thresh"], (0, pad)),
        "left": torch.cat([params["left"], self_loop], dim=1),
        "right": torch.cat([params["right"], self_loop], dim=1),
        "leaf": torch.cat([leaf, leaf_pad], dim=1),
    }


def forest_predict_proba(params: dict[str, torch.Tensor], x: torch.Tensor,
                         max_depth: int) -> torch.Tensor:
    """Vectorized forest inference.  x: (B, F) -> (B, C) probabilities.

    The tree average adds trees in order and divides by T, on every
    device alike, so the card and the CPU give the same probabilities."""
    feature, thresh = params["feature"], params["thresh"]
    left, right, leaf = params["left"], params["right"], params["leaf"]
    T = feature.shape[0]
    B = x.shape[0]
    t_ar = torch.arange(T, device=x.device)[None, :]
    idx = torch.zeros((B, T), dtype=torch.int64, device=x.device)
    for _ in range(max_depth + 1):
        f = feature[t_ar, idx]                               # (B, T)
        thr = thresh[t_ar, idx]
        xv = x.gather(1, f.clamp(min=0).long())              # (B, T)
        go_left = (xv <= thr) | (f < 0)
        idx = torch.where(go_left, left[t_ar, idx],
                          right[t_ar, idx]).long()
    probs = leaf[t_ar, idx]                                  # (B, T, C)
    total = probs[:, 0]
    for t in range(1, T):
        total = total + probs[:, t]
    return total / T
