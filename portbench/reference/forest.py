"""The forest cascade: bagged histogram-greedy trees, fit on the host.

A frozen copy of the recipe of ``src/repro_torch/core/forest.py`` and
``core/cascade.py`` (paper Algorithm 1 and 2): node i of the cascade is
a forest trained on "class <= i", and a query exits at the first node
whose class-0 probability clears the threshold, else takes class c.
Trees are flat tables (feature, thresh, left, right, leaf) with
self-looping leaves.  Fitting is NumPy; prediction is PyTorch in a
chosen precision, on any device.
"""

from __future__ import annotations

import numpy as np
import torch

TABLES = ("feature", "thresh", "left", "right", "leaf")


def _gini_gain(hl, hr):
    nl, nr = hl.sum(-1), hr.sum(-1)
    n = nl + nr
    with np.errstate(divide="ignore", invalid="ignore"):
        gl = 1.0 - ((hl / np.maximum(nl[:, None], 1)) ** 2).sum(-1)
        gr = 1.0 - ((hr / np.maximum(nr[:, None], 1)) ** 2).sum(-1)
    tot = hl + hr
    gp = 1.0 - ((tot / np.maximum(n[:, None], 1)) ** 2).sum(-1)
    gain = gp - (nl / np.maximum(n, 1)) * gl - (nr / np.maximum(n, 1)) * gr
    gain[(nl == 0) | (nr == 0)] = -1.0
    return gain


def _fit_tree(xb, y, edges, n_classes, rng, max_depth, feat_frac,
              min_leaf):
    n_feat = xb.shape[1]
    bins = edges.shape[1] + 1
    m = max(1, int(round(feat_frac * n_feat)))
    nodes = []

    def leaf(idx):
        hist = np.bincount(y[idx], minlength=n_classes).astype(np.float64)
        nodes.append(dict(feature=-1, thresh=0.0, leaf=hist / max(
            hist.sum(), 1.0)))
        nid = len(nodes) - 1
        nodes[nid]["left"] = nodes[nid]["right"] = nid
        return nid

    def grow(idx, depth):
        if (depth >= max_depth or len(idx) < 2 * min_leaf
                or len(np.unique(y[idx])) == 1):
            return leaf(idx)
        best = (-1.0, None, None)
        for f in rng.choice(n_feat, size=m, replace=False):
            h = np.bincount(xb[idx, f] * n_classes + y[idx],
                            minlength=bins * n_classes).astype(
                                np.float64).reshape(bins, n_classes)
            cum = np.cumsum(h, axis=0)
            gain = _gini_gain(cum[:-1], cum[-1][None, :] - cum[:-1])
            b = int(np.argmax(gain))
            if gain[b] > best[0]:
                best = (float(gain[b]), int(f), b)
        if best[1] is None or best[0] <= 1e-12:
            return leaf(idx)
        _, f, b = best
        go_l = xb[idx, f] <= b
        li, ri = idx[go_l], idx[~go_l]
        if len(li) < min_leaf or len(ri) < min_leaf:
            return leaf(idx)
        nid = len(nodes)
        nodes.append(dict(feature=f, thresh=float(edges[f, b]),
                          leaf=np.zeros(n_classes)))
        nodes[nid]["left"] = grow(li, depth + 1)
        nodes[nid]["right"] = grow(ri, depth + 1)
        return nid

    grow(np.arange(xb.shape[0]), 0)
    return nodes


def fit_forest(x, y, *, n_classes, n_trees, max_depth, bins, feat_frac,
               min_leaf, seed) -> dict:
    """Bagged trees over quantile-binned features: a dict of the flat
    tables, padded to the widest tree (padding: class-0 leaves)."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int64)
    n, n_feat = x.shape
    qs = np.linspace(0, 1, bins + 1)[1:-1]
    edges = np.quantile(x, qs, axis=0).T.astype(np.float32)
    edges = np.maximum.accumulate(edges + np.arange(bins - 1) * 1e-12,
                                  axis=1)
    xb = np.stack([np.searchsorted(edges[f], x[:, f], side="right")
                   for f in range(n_feat)], axis=1).astype(np.int64)
    rng = np.random.default_rng(seed)
    trees = []
    for _ in range(n_trees):
        boot = rng.integers(0, n, size=n)
        trees.append(_fit_tree(xb[boot], y[boot], edges, n_classes, rng,
                               max_depth, feat_frac, min_leaf))
    width = max(len(t) for t in trees)
    out = dict(feature=np.full((n_trees, width), -1, np.int32),
               thresh=np.zeros((n_trees, width), np.float32),
               left=np.zeros((n_trees, width), np.int32),
               right=np.zeros((n_trees, width), np.int32),
               leaf=np.zeros((n_trees, width, n_classes), np.float32))
    out["leaf"][:, :, 0] = 1.0
    for t, tree in enumerate(trees):
        for i, nd in enumerate(tree):
            for k in TABLES:
                out[k][t, i] = nd[k]
    return out


def fit_cascade(x, labels, *, n_cutoffs, seed, **forest_kw) -> list:
    """One forest a cutoff boundary, node i on "class > i" (Algorithm 1)."""
    labels = np.asarray(labels)
    return [fit_forest(x, (labels > i).astype(np.int64), n_classes=2,
                       seed=seed + i, **forest_kw)
            for i in range(n_cutoffs)]


def proba0(tables: dict, x: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Class-0 probability of one forest, (B,), in ``x``'s dtype: the
    trees walked ``max_depth + 1`` rounds, their leaves added in tree
    order and divided by the tree count."""
    dev, dt = x.device, x.dtype
    feature = torch.as_tensor(tables["feature"], device=dev).long()
    thresh = torch.as_tensor(tables["thresh"], device=dev).to(dt)
    left = torch.as_tensor(tables["left"], device=dev).long()
    right = torch.as_tensor(tables["right"], device=dev).long()
    leaf = torch.as_tensor(tables["leaf"], device=dev).to(dt)
    n_trees = feature.shape[0]
    t = torch.arange(n_trees, device=dev)[None, :]
    node = torch.zeros((x.shape[0], n_trees), dtype=torch.long, device=dev)
    for _ in range(max_depth + 1):
        f = feature[t, node]
        go_left = (x.gather(1, f.clamp(min=0)) <= thresh[t, node]) | (f < 0)
        node = torch.where(go_left, left[t, node], right[t, node])
    p = leaf[t, node][..., 0]                      # (B, T)
    total = p[:, 0]
    for i in range(1, n_trees):
        total = total + p[:, i]
    return total / n_trees


def classes(cascade: list, x: torch.Tensor, *, max_depth: int,
            threshold: float) -> torch.Tensor:
    """First node whose class-0 probability exceeds ``threshold``, else
    the cascade's length: (B,) int64."""
    p0 = torch.stack([proba0(t, x, max_depth) for t in cascade], dim=1)
    fire = p0 > torch.tensor(threshold, dtype=torch.float32).to(p0.dtype)
    first = fire.to(torch.int32).argmax(dim=1).long()
    return torch.where(fire.any(dim=1), first,
                       torch.full_like(first, len(cascade)))
