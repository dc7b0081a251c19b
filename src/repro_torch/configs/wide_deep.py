"""wide-deep — 40 sparse fields, embed 32, MLP 1024-512-256
[arXiv:1606.07792]; the JAX package's ``configs/wide_deep.py`` without
its dry-run bundle."""

from __future__ import annotations

from repro_torch.configs import recsys_common as RC
from repro_torch.models.recsys import wide_deep as WD

ARCH = "wide-deep"
SHAPES = dict(RC.RECSYS_SHAPES)


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
