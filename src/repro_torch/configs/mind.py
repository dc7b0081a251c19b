"""mind — multi-interest capsule retrieval, embed 64, 4 interests
[arXiv:1904.08030]; the JAX package's ``configs/mind.py``.
``REPRO_RETRIEVAL_BF16=1`` selects bfloat16 parameters, as the
reference's switch does.

MIND is natively a *retrieval* model, so its retrieval_cand cell scores
the 1M candidates with its own multi-interest user representation (max
over interests) instead of the generic two-tower.  Its top-k is
``retrieval_tower.top_k`` (which gathers the scores whole), or with
``REPRO_SHARDED_TOPK=1``, as the reference's switch selects,
``distrib.collectives.sharded_topk`` over the ``model`` axis: a local
top-k of each device's column block and an all-gather of the survivors
alone."""

from __future__ import annotations

import functools
import os

import torch

from repro_torch.configs import recsys_common as RC
from repro_torch.configs.base import Bundle, abstract_tree, fake_mode
from repro_torch.distrib import collectives as C
from repro_torch.distrib import sharding as S
from repro_torch.distrib.sharding import P
from repro_torch.models.layers import gather_rows
from repro_torch.models.recsys import mind as MD
from repro_torch.models.recsys import retrieval_tower as RT

ARCH = "mind"
SHAPES = dict(RC.RECSYS_SHAPES)
SKIPS: dict[str, str] = {}


def model_config() -> MD.MINDConfig:
    # bf16 candidate embeddings halve the retrieval scan
    dt = "bfloat16" if os.environ.get("REPRO_RETRIEVAL_BF16") == "1" \
        else "float32"
    return MD.MINDConfig(embed_dim=64, n_interests=4, capsule_iters=3,
                         seq_len=50, item_vocab=1_000_000, dtype=dt)


def smoke_config() -> MD.MINDConfig:
    return MD.MINDConfig(embed_dim=8, n_interests=3, capsule_iters=3,
                         seq_len=10, item_vocab=60)


def _model_flops(cfg, b, kind):
    t, d, k = cfg.seq_len, cfg.embed_dim, cfg.n_interests
    routing = 2 * t * d * d + cfg.capsule_iters * (2 * t * k * d * 2)
    fwd = b * routing
    return (3.0 if kind == "train" else 1.0) * fwd


def _batch_abs(cfg, b):
    return {
        "hist_items": torch.empty((b, cfg.seq_len), dtype=torch.int32),
        "target_item": torch.empty((b,), dtype=torch.int32),
    }


def _retrieval_bundle(cfg, shape: str, mesh) -> Bundle:
    sh = RC.RECSYS_SHAPES[shape]
    params_abs = abstract_tree(MD.init_mind(cfg, abstract=True))
    p_specs = dict(S.recsys_param_specs(params_abs, mesh))
    p_specs["item_table"] = P("model", None)      # candidates row-sharded
    with fake_mode():
        hist_abs = torch.empty((sh["batch"], cfg.seq_len), dtype=torch.int32)
    k = sh["k"]
    use_sharded = os.environ.get("REPRO_SHARDED_TOPK", "0") == "1"

    def retrieve(params, hist):
        v = MD.mind_interests(params, cfg, hist)              # (B, K, D)
        scores = torch.einsum("bkd,nd->bkn", v, params["item_table"])
        best = scores.amax(dim=1).to(torch.float32)           # (B, N)
        if use_sharded:
            return C.sharded_topk(mesh, best, k, axis="model")
        idx, vals = RT.top_k(best, k)
        return vals, idx.to(torch.int32)

    meta = dict(arch=ARCH, shape=shape, kind="retrieve", batch=sh["batch"],
                params=RC.param_count(params_abs),
                model_flops=2.0 * sh["batch"] * cfg.n_interests
                * cfg.item_vocab * cfg.embed_dim)
    return Bundle(fn=retrieve, args=(params_abs, hist_abs),
                  in_shardings=(S.tree_shardings(mesh, p_specs),
                                S.NamedSharding(mesh, P(None, None))),
                  out_shardings=None, donate_argnums=(), hints={},
                  meta=meta)


def _logits(cfg, p, b):
    target = gather_rows(p["item_table"], b["target_item"].clamp(min=0))
    return MD.mind_score(p, cfg, MD.mind_interests(p, cfg, b["hist_items"]),
                         target)


def dryrun_bundle(shape: str, mesh, mode: str = "cost") -> Bundle:
    del mode  # no scans in this arch: one probe serves both
    cfg = model_config()
    if shape == "retrieval_cand":
        return _retrieval_bundle(cfg, shape, mesh)
    params_abs = abstract_tree(MD.init_mind(cfg, abstract=True))
    return RC.ranking_bundle(
        arch=ARCH, shape_name=shape, mesh=mesh, params_abs=params_abs,
        loss_fn=lambda p, b: MD.mind_loss(p, cfg, b),
        logits_fn=functools.partial(_logits, cfg),
        batch_abs_fn=functools.partial(_batch_abs, cfg),
        model_flops_fn=functools.partial(_model_flops, cfg))
