"""Synthetic graphs of the GraphSAGE shapes: a numpy copy of the JAX
package's ``data/graph_data.py``, bit-equal to it for the same config.

Power-law(ish) degree structure via preferential chunks, deterministic in
the seed.  The generator also makes the Reddit-scale graph (232 965
nodes, 114.6 M edges) on the host, which the card then trains on; the
molecule cell is a batch of small graphs as one disjoint union.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["GraphConfig", "make_graph", "molecule_batch"]


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int = 41
    seed: int = 0


def make_graph(cfg: GraphConfig) -> dict[str, np.ndarray]:
    r = np.random.default_rng(cfg.seed)
    # preferential attachment flavour: half uniform, half to sqrt(N) hubs
    n_hub = max(int(np.sqrt(cfg.n_nodes)), 1)
    hubs = r.integers(0, cfg.n_nodes, n_hub)
    src_u = r.integers(0, cfg.n_nodes, cfg.n_edges // 2)
    src_h = hubs[r.integers(0, n_hub, cfg.n_edges - cfg.n_edges // 2)]
    src = np.concatenate([src_u, src_h])
    dst = r.integers(0, cfg.n_nodes, cfg.n_edges)
    edges = np.stack([src, dst]).astype(np.int32)
    feats = r.normal(size=(cfg.n_nodes, cfg.d_feat)).astype(np.float32)
    # planted labels: class = argmax of a random projection of features
    w = r.normal(size=(cfg.d_feat, cfg.n_classes))
    labels = np.argmax(feats @ w + 0.5 * r.normal(
        size=(cfg.n_nodes, cfg.n_classes)), axis=1).astype(np.int32)
    mask = r.random(cfg.n_nodes) < 0.7
    return {"edges": edges, "feats": feats, "labels": labels,
            "train_mask": mask}


def molecule_batch(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                   seed: int = 0) -> dict[str, np.ndarray]:
    """Batched small graphs (molecule cell): one disjoint union per batch,
    node offsets applied so a single edge list serves the whole batch."""
    r = np.random.default_rng(seed)
    offs = np.arange(batch) * n_nodes
    src = (r.integers(0, n_nodes, (batch, n_edges)) + offs[:, None]).ravel()
    dst = (r.integers(0, n_nodes, (batch, n_edges)) + offs[:, None]).ravel()
    feats = r.normal(size=(batch * n_nodes, d_feat)).astype(np.float32)
    graph_id = np.repeat(np.arange(batch), n_nodes)
    y = r.normal(size=(batch,)).astype(np.float32)
    return {"edges": np.stack([src, dst]).astype(np.int32),
            "feats": feats, "graph_id": graph_id.astype(np.int32),
            "y": y}
