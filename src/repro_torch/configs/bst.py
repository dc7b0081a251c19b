"""bst — Behavior Sequence Transformer, 1 block, 8 heads
[arXiv:1905.06874]; the configurations live in ``configs/recsys.py``
(the funnel's), re-exported here with the JAX package's
``configs/bst.py:_model_flops`` and ``dryrun_bundle``."""

from __future__ import annotations

import functools

import torch

from repro_torch.configs import recsys_common as RC
from repro_torch.configs.base import Bundle, abstract_tree
from repro_torch.configs.recsys import bst_model_config as model_config
from repro_torch.configs.recsys import bst_smoke_config as smoke_config
from repro_torch.models.recsys import bst as BS

__all__ = ["ARCH", "SHAPES", "SKIPS", "model_config", "smoke_config",
           "dryrun_bundle"]

ARCH = "bst"
SHAPES = dict(RC.RECSYS_SHAPES)
SKIPS: dict[str, str] = {}


def _model_flops(cfg, b, kind):
    t, d = cfg.seq_len + 1, cfg.embed_dim
    attn = cfg.n_blocks * (4 * 2 * t * d * d + 2 * 2 * t * t * d
                           + 2 * 2 * t * d * cfg.ff_mult * d)
    d_in = t * d + cfg.n_profile
    mlp = 0
    for h in cfg.mlp:
        mlp += 2 * d_in * h
        d_in = h
    fwd = b * (attn + mlp)
    return (3.0 if kind == "train" else 1.0) * fwd


def _batch_abs(cfg, b):
    return {
        "hist_items": torch.empty((b, cfg.seq_len), dtype=torch.int32),
        "target_item": torch.empty((b,), dtype=torch.int32),
        "profile": torch.empty((b, cfg.n_profile), dtype=torch.float32),
        "label": torch.empty((b,), dtype=torch.int32),
    }


def dryrun_bundle(shape: str, mesh, mode: str = "cost") -> Bundle:
    del mode  # no scans in this arch: one probe serves both
    cfg = model_config()
    if shape == "retrieval_cand":
        return RC.retrieval_bundle(arch=ARCH, mesh=mesh)
    params_abs = abstract_tree(BS.init_bst(cfg, abstract=True))
    return RC.ranking_bundle(
        arch=ARCH, shape_name=shape, mesh=mesh, params_abs=params_abs,
        loss_fn=lambda p, b: BS.bst_loss(p, cfg, b),
        logits_fn=lambda p, b: BS.bst_logits(p, cfg, b),
        batch_abs_fn=functools.partial(_batch_abs, cfg),
        model_flops_fn=functools.partial(_model_flops, cfg))
