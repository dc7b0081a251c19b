"""dien — GRU+AUGRU interest evolution, embed 18, seq 100
[arXiv:1809.03672]; the JAX package's ``configs/dien.py``."""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs import recsys_common as RC
from repro_torch.configs.base import Bundle, abstract_tree
from repro_torch.models.recsys import dien as DN

ARCH = "dien"
SHAPES = dict(RC.RECSYS_SHAPES)
SKIPS: dict[str, str] = {}


def model_config() -> DN.DIENConfig:
    return DN.DIENConfig(embed_dim=18, seq_len=100, gru_dim=108,
                         item_vocab=1_000_000, cat_vocab=10_000,
                         n_profile=8, mlp=(200, 80))


def smoke_config() -> DN.DIENConfig:
    return DN.DIENConfig(embed_dim=6, seq_len=12, gru_dim=12,
                         item_vocab=100, cat_vocab=10, n_profile=4,
                         mlp=(16, 8))


def _model_flops(cfg, b, kind):
    # two GRUs: T steps x 3 gates x 2*(d_in+d_h)*d_h
    g1 = cfg.seq_len * 3 * 2 * (cfg.d_behavior + cfg.gru_dim) * cfg.gru_dim
    g2 = cfg.seq_len * 3 * 2 * (2 * cfg.gru_dim) * cfg.gru_dim
    d_in = cfg.gru_dim + cfg.d_behavior + cfg.n_profile
    mlp = 0
    for h in cfg.mlp:
        mlp += 2 * d_in * h
        d_in = h
    fwd = b * (g1 + g2 + mlp)
    return (3.0 if kind == "train" else 1.0) * fwd


def _batch_abs(cfg, b):
    t = cfg.seq_len
    i32 = torch.int32
    return {
        "hist_items": torch.empty((b, t), dtype=i32),
        "hist_cats": torch.empty((b, t), dtype=i32),
        "target_item": torch.empty((b,), dtype=i32),
        "target_cat": torch.empty((b,), dtype=i32),
        "profile": torch.empty((b, cfg.n_profile), dtype=torch.float32),
        "label": torch.empty((b,), dtype=i32),
    }


def dryrun_bundle(shape: str, mesh, mode: str = "cost") -> Bundle:
    cfg = dataclasses.replace(model_config(), unroll=(mode == "cost"))
    if shape == "retrieval_cand":
        return RC.retrieval_bundle(arch=ARCH, mesh=mesh)
    params_abs = abstract_tree(DN.init_dien(cfg, abstract=True))
    return RC.ranking_bundle(
        arch=ARCH, shape_name=shape, mesh=mesh, params_abs=params_abs,
        loss_fn=lambda p, b: DN.dien_loss(p, cfg, b),
        logits_fn=lambda p, b: DN.dien_logits(p, cfg, b),
        batch_abs_fn=functools.partial(_batch_abs, cfg),
        model_flops_fn=functools.partial(_model_flops, cfg))
