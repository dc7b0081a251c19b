"""dien — GRU+AUGRU interest evolution, embed 18, seq 100
[arXiv:1809.03672]; the JAX package's ``configs/dien.py`` without its
dry-run bundle."""

from __future__ import annotations

from repro_torch.configs import recsys_common as RC
from repro_torch.models.recsys import dien as DN

ARCH = "dien"
SHAPES = dict(RC.RECSYS_SHAPES)


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
