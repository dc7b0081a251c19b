"""graphsage-reddit — 2 layers, d_hidden 128, mean aggregator
[arXiv:1706.02216].  A copy of the JAX package's config.

Four shapes, three regimes: full-batch (Cora-size + ogbn-products-size),
sampled minibatch at Reddit scale (the paper's own setting: 232,965 nodes /
114.6M edges, fanout 15-10), and batched small graphs.

``dryrun_bundle`` is the reference's (parameters placed by
``sage_param_specs``, edges sharded over every mesh axis, node arrays
replicated); ``model_flops`` is its count of a training step's model
FLOPs.  The reference's example runs as ``python -m
repro_torch.examples.gnn_sage``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import (Bundle, abstract_tree, fake_mode,
                                      train_step_fn)
from repro_torch.distrib import sharding as S
from repro_torch.distrib.sharding import P
from repro_torch.models import gnn
from repro_torch.tree import leaves

__all__ = ["ARCH", "SHAPES", "SKIPS", "model_config", "smoke_config",
           "model_flops", "dryrun_bundle"]

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


def _all_axes(mesh):
    return tuple(mesh.axis_names)


def _step(loss_fn, adam):
    """The bundle's step over positional data arguments."""
    inner = train_step_fn(lambda p, args: loss_fn(p, *args), adam)
    return lambda params, opt, *args: inner(params, opt, args)


def dryrun_bundle(shape: str, mesh, mode: str = "cost") -> Bundle:
    from repro_torch.optim import adamw

    del mode  # no scans: one probe serves both
    sh = SHAPES[shape]
    cfg = model_config(shape)
    adam = adamw.AdamWConfig(lr=1e-3, weight_decay=0.0)
    params_abs = abstract_tree(gnn.init_sage(cfg, abstract=True))
    p_sh = S.tree_shardings(mesh, S.sage_param_specs(params_abs, mesh))
    with fake_mode():
        opt_abs = adamw.init_opt_state(params_abs)
    o_sh = S.tree_shardings(mesh, S.sage_param_specs(opt_abs, mesh))
    dp = S.dp_axes(mesh)
    dp_ax = dp if len(dp) > 1 else dp[0]
    edge_sh = S.NamedSharding(mesh, P(None, _all_axes(mesh)))
    node_sh = S.NamedSharding(mesh, P(None, None))
    vec_sh = S.NamedSharding(mesh, P(None))
    meta = dict(arch=ARCH, shape=shape, kind=sh["kind"],
                params=int(sum(math.prod(t.shape) for t in
                               leaves(params_abs))),
                n_edges=sh["n_edges"], d_feat=sh["d_feat"],
                model_flops=model_flops(shape))
    i32, f32 = torch.int32, torch.float32

    if sh["kind"] == "train_full":
        e, n = sh["n_edges"], sh["n_nodes"]
        # argument shardings need divisibility: edges padded up to a
        # multiple of the mesh size (padding edges self-loop on a ghost
        # node, which the train mask excludes)
        n_dev = math.prod(mesh.shape.values())
        e = -(-e // n_dev) * n_dev
        n = n + 1
        meta["padding"] = {"n_edges_padded": e, "ghost_node": n - 1}
        with fake_mode():
            args = (torch.empty((n, sh["d_feat"]), dtype=f32),
                    torch.empty((2, e), dtype=i32),
                    torch.empty((n,), dtype=i32),
                    torch.empty((n,), dtype=torch.bool))
        return Bundle(
            fn=_step(lambda p, *a: gnn.sage_loss_full(p, cfg, *a), adam),
            args=(params_abs, opt_abs, *args),
            in_shardings=(p_sh, o_sh, node_sh, edge_sh, vec_sh, vec_sh),
            out_shardings=(p_sh, o_sh, None), donate_argnums=(0, 1),
            hints={}, meta=meta)

    if sh["kind"] == "train_blocks":
        bn = sh["batch_nodes"]
        f1, f2 = sh["fanout"]
        sizes = (bn, bn * f1, bn * f1 * f2)
        with fake_mode():
            feats = [torch.empty((s, sh["d_feat"]), dtype=f32)
                     for s in sizes]
            blocks = [{"src_index": torch.empty((sizes[i + 1],), dtype=i32),
                       "dst_index": torch.empty((sizes[i + 1],), dtype=i32)}
                      for i in range(2)]
            labels = torch.empty((bn,), dtype=i32)
        row_sh = S.NamedSharding(mesh, P(dp_ax, None))
        idx_sh = S.NamedSharding(mesh, P(dp_ax))
        return Bundle(
            fn=_step(lambda p, *a: gnn.sage_loss_blocks(p, cfg, *a), adam),
            args=(params_abs, opt_abs, feats, blocks, labels),
            in_shardings=(p_sh, o_sh, [row_sh] * 3,
                          [{"src_index": idx_sh, "dst_index": idx_sh}] * 2,
                          idx_sh),
            out_shardings=(p_sh, o_sh, None), donate_argnums=(0, 1),
            hints={}, meta=meta)

    # molecule: batched small graphs
    b, npg, epg = sh["batch"], sh["n_nodes"], sh["n_edges"]
    n, e = b * npg, b * epg
    with fake_mode():
        args = (torch.empty((n, sh["d_feat"]), dtype=f32),
                torch.empty((2, e), dtype=i32),
                torch.empty((n,), dtype=i32),
                torch.empty((b,), dtype=f32))
    return Bundle(
        fn=_step(lambda p, *a: gnn.sage_loss_molecule(p, cfg, *a, b), adam),
        args=(params_abs, opt_abs, *args),
        in_shardings=(p_sh, o_sh, node_sh, edge_sh,
                      S.NamedSharding(mesh, P(None)),
                      S.NamedSharding(mesh, P(None))),
        out_shardings=(p_sh, o_sh, None), donate_argnums=(0, 1), hints={},
        meta=meta)
