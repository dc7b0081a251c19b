"""mind — multi-interest capsule retrieval, embed 64, 4 interests
[arXiv:1904.08030]; the JAX package's ``configs/mind.py`` without its
dry-run bundle.  ``REPRO_RETRIEVAL_BF16=1`` selects bfloat16 parameters,
as the reference's switch does."""

from __future__ import annotations

import os

from repro_torch.configs import recsys_common as RC
from repro_torch.models.recsys import mind as MD

ARCH = "mind"
SHAPES = dict(RC.RECSYS_SHAPES)


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
