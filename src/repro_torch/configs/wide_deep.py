"""wide-deep — 40 sparse fields, embed 32, MLP 1024-512-256
[arXiv:1606.07792]; the JAX package's ``configs/wide_deep.py``."""

from __future__ import annotations

import functools

import torch

from repro_torch.configs import recsys_common as RC
from repro_torch.configs.base import Bundle, abstract_tree
from repro_torch.models.recsys import wide_deep as WD

ARCH = "wide-deep"
SHAPES = dict(RC.RECSYS_SHAPES)
SKIPS: dict[str, str] = {}


def model_config() -> WD.WideDeepConfig:
    return WD.WideDeepConfig(n_sparse=40, n_dense=13, n_cross=8,
                             embed_dim=32, vocab_per_field=1_000_000,
                             cross_vocab=100_000, mlp=(1024, 512, 256))


def smoke_config() -> WD.WideDeepConfig:
    return WD.WideDeepConfig(n_sparse=6, n_dense=4, n_cross=2, embed_dim=8,
                             vocab_per_field=200, cross_vocab=50,
                             mlp=(32, 16))


def _model_flops(cfg, b, kind):
    d_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    mlp = 0
    for h in cfg.mlp:
        mlp += 2 * d_in * h
        d_in = h
    fwd = b * (mlp + 2 * d_in)
    return (3.0 if kind == "train" else 1.0) * fwd


def _batch_abs(cfg, b):
    return {
        "sparse_ids": torch.empty((b, cfg.n_sparse), dtype=torch.int32),
        "cross_ids": torch.empty((b, cfg.n_cross), dtype=torch.int32),
        "dense": torch.empty((b, cfg.n_dense), dtype=torch.float32),
        "label": torch.empty((b,), dtype=torch.int32),
    }


def dryrun_bundle(shape: str, mesh, mode: str = "cost") -> Bundle:
    del mode  # no scans in this arch: one probe serves both
    cfg = model_config()
    if shape == "retrieval_cand":
        return RC.retrieval_bundle(arch=ARCH, mesh=mesh)
    params_abs = abstract_tree(WD.init_wide_deep(cfg, abstract=True))
    return RC.ranking_bundle(
        arch=ARCH, shape_name=shape, mesh=mesh, params_abs=params_abs,
        loss_fn=lambda p, b: WD.wide_deep_loss(p, cfg, b),
        logits_fn=lambda p, b: WD.wide_deep_logits(p, cfg, b),
        batch_abs_fn=functools.partial(_batch_abs, cfg),
        model_flops_fn=functools.partial(_model_flops, cfg))
