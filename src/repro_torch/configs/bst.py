"""bst — Behavior Sequence Transformer, 1 block, 8 heads
[arXiv:1905.06874]; the configurations live in ``configs/recsys.py``
(the funnel's), re-exported here with the JAX package's
``configs/bst.py:_model_flops``."""

from __future__ import annotations

from repro_torch.configs import recsys_common as RC
from repro_torch.configs.recsys import bst_model_config as model_config
from repro_torch.configs.recsys import bst_smoke_config as smoke_config

__all__ = ["ARCH", "SHAPES", "model_config", "smoke_config"]

ARCH = "bst"
SHAPES = dict(RC.RECSYS_SHAPES)


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
