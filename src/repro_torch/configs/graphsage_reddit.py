"""graphsage-reddit — 2 layers, d_hidden 128, mean aggregator
[arXiv:1706.02216].  A copy of the JAX package's config.

Four shapes, three regimes: full-batch (Cora-size + ogbn-products-size),
sampled minibatch at Reddit scale (the paper's own setting: 232,965 nodes /
114.6M edges, fanout 15-10), and batched small graphs.

The reference's ``dryrun_bundle`` (and the ``sage_param_specs`` it
places parameters by) waits for ROADMAP item 7d; ``model_flops`` is its
count of a training step's model FLOPs.  The driver of the reference's
example is ``python -m repro_torch.examples.gnn_sage``.
"""

from __future__ import annotations

from repro_torch.models import gnn

__all__ = ["ARCH", "SHAPES", "SKIPS", "model_config", "smoke_config",
           "model_flops"]

ARCH = "graphsage-reddit"

SHAPES = {
    "full_graph_sm": dict(kind="train_full", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    "minibatch_lg": dict(kind="train_blocks", n_nodes=232965,
                         n_edges=114615892, batch_nodes=1024,
                         fanout=(15, 10), d_feat=602, n_classes=41),
    "ogb_products": dict(kind="train_full", n_nodes=2449029,
                         n_edges=61859140, d_feat=100, n_classes=47),
    "molecule": dict(kind="train_molecule", n_nodes=30, n_edges=64,
                     batch=128, d_feat=32, n_classes=1),
}
SKIPS: dict[str, str] = {}


def model_config(shape: str = "minibatch_lg") -> gnn.SageConfig:
    sh = SHAPES[shape]
    return gnn.SageConfig(n_layers=2, d_in=sh["d_feat"], d_hidden=128,
                          n_classes=max(sh["n_classes"], 2),
                          aggregator="mean")


def smoke_config() -> gnn.SageConfig:
    return gnn.SageConfig(n_layers=2, d_in=16, d_hidden=8, n_classes=5)


def model_flops(shape: str) -> float:
    """Model FLOPs of one training step of ``shape``: the gathers and
    the products of each layer, three times the forward's (the
    reference bundle's ``meta["model_flops"]``)."""
    sh = SHAPES[shape]
    d = model_config(shape).d_hidden
    if sh["kind"] == "train_full":
        e, n = sh["n_edges"], sh["n_nodes"]
        return 3.0 * (2 * e * sh["d_feat"]
                      + 2 * n * (sh["d_feat"] + d) * d * 2)
    if sh["kind"] == "train_blocks":
        bn, (f1, f2) = sh["batch_nodes"], sh["fanout"]
        sizes = (bn, bn * f1, bn * f1 * f2)
        return 3.0 * (2 * sizes[2] * sh["d_feat"]
                      + 2 * (sizes[0] + sizes[1]) * (sh["d_feat"] + d) * d
                      * 2)
    n, e = sh["batch"] * sh["n_nodes"], sh["batch"] * sh["n_edges"]
    return 3.0 * (2 * e * sh["d_feat"] + 2 * n * (sh["d_feat"] + d) * d * 2)
