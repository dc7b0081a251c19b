"""Shared dry-run bundles of the recsys family (the port of the JAX
package's ``configs/recsys_common.py``).

Four shapes per arch:
  train_batch     batch 65,536            -> train_step
  serve_p99       batch 512               -> ranking forward (online)
  serve_bulk      batch 262,144           -> ranking forward (offline)
  retrieval_cand  1 query x 1M candidates -> stage-1 retrieval + top-k

retrieval_cand is where the paper's technique lives in this family: the
two-tower (or MIND multi-interest) stage 1 scores the candidate universe
and the cascade picks the per-query k.  Candidate embeddings are
row-sharded over 'model' so the stage-1 top-k is local plus a
cross-shard merge, as the ``topk`` kernel's two stages are.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import (Bundle, abstract_tree, fake_mode,
                                      train_step_fn)
from repro_torch.distrib import sharding as S
from repro_torch.distrib.sharding import P
from repro_torch.tree import leaves

__all__ = ["RECSYS_SHAPES", "ranking_bundle", "retrieval_bundle",
           "param_count"]

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieve", batch=1,
                           n_candidates=1_000_000, k=1000),
}


def param_count(tree) -> int:
    return int(sum(math.prod(leaf.shape) for leaf in leaves(tree)))


def _batch_sharding(mesh, batch_abs, batch: int):
    """Batch over the dp axes where it divides, else replicated."""
    dp = S.dp_axes(mesh)
    dp_ax = dp if len(dp) > 1 else dp[0]
    n = S.MeshInfo(mesh).dp_size
    ax = dp_ax if batch % n == 0 and batch >= n else None
    return {k: S.NamedSharding(mesh, P(ax, *([None] * (v.dim() - 1))))
            for k, v in batch_abs.items()}


def ranking_bundle(*, arch: str, shape_name: str, mesh, params_abs,
                   loss_fn, logits_fn, batch_abs_fn, model_flops_fn,
                   adam=None) -> Bundle:
    """Generic train/serve bundle of the ranking models.

    loss_fn(params, batch) -> scalar; logits_fn(params, batch) -> (B,);
    batch_abs_fn(batch_size) -> dict of fake tensors."""
    from repro_torch.optim import adamw

    sh = RECSYS_SHAPES[shape_name]
    adam = adam or adamw.AdamWConfig(lr=1e-3, weight_decay=1e-5)
    p_specs = S.recsys_param_specs(params_abs, mesh)
    p_sh = S.tree_shardings(mesh, p_specs)
    with fake_mode():
        batch_abs = batch_abs_fn(sh["batch"])
    b_sh = _batch_sharding(mesh, batch_abs, sh["batch"])
    meta = dict(arch=arch, shape=shape_name, kind=sh["kind"],
                batch=sh["batch"], params=param_count(params_abs),
                model_flops=model_flops_fn(sh["batch"], sh["kind"]))

    if sh["kind"] == "train":
        with fake_mode():
            opt_abs = adamw.init_opt_state(params_abs)
        o_sh = S.tree_shardings(mesh, S.lm_opt_specs(p_specs, params_abs,
                                                     mesh))
        return Bundle(fn=train_step_fn(loss_fn, adam),
                      args=(params_abs, opt_abs, batch_abs),
                      in_shardings=(p_sh, o_sh, b_sh),
                      out_shardings=(p_sh, o_sh, None),
                      donate_argnums=(0, 1), hints={}, meta=meta)

    def serve(params, batch):
        return logits_fn(params, batch)

    return Bundle(fn=serve, args=(params_abs, batch_abs),
                  in_shardings=(p_sh, b_sh), out_shardings=None,
                  donate_argnums=(), hints={}, meta=meta)


def retrieval_bundle(*, arch: str, mesh, shape_name: str = "retrieval_cand",
                     tower_cfg=None) -> Bundle:
    """Stage-1 retrieval cell: one query scored against 1M candidates."""
    from repro_torch.models.recsys import retrieval_tower as RT

    sh = RECSYS_SHAPES[shape_name]
    cfg = tower_cfg or RT.TowerConfig(n_candidates=sh["n_candidates"])
    params_abs = abstract_tree(RT.init_tower(cfg, abstract=True))
    # candidates row-sharded over 'model': local top-k + merge
    p_specs = dict(S.recsys_param_specs(params_abs, mesh))
    p_specs["items"] = P("model", None)
    p_sh = S.tree_shardings(mesh, p_specs)
    with fake_mode():
        feats_abs = torch.empty((sh["batch"], cfg.d_user_in),
                                dtype=torch.float32)
    k = sh["k"]
    meta = dict(arch=arch, shape=shape_name, kind="retrieve",
                batch=sh["batch"], params=param_count(params_abs),
                model_flops=2.0 * sh["batch"] * sh["n_candidates"]
                * cfg.embed_dim)

    def retrieve(params, feats):
        return RT.retrieve_topk(params, cfg, feats, k)

    return Bundle(fn=retrieve, args=(params_abs, feats_abs),
                  in_shardings=(p_sh, S.NamedSharding(mesh, P(None, None))),
                  out_shardings=None, donate_argnums=(), hints={},
                  meta=meta)
