"""The recsys funnel's configurations, copied from the JAX package.

* ``bst_model_config``: ``configs/bst.py:model_config`` (embed 32,
  seq_len 20, 1 block, 8 heads of 4, 2 M items, 8 profile features, MLP
  1024-512-256), arXiv:1905.06874;
* ``bst_smoke_config``: ``configs/bst.py:smoke_config``;
* ``tower_config``: the default ``TowerConfig`` (64 user features, MLP
  256-128 to a 64-wide embedding, 1 M candidates), the
  ``retrieval_cand`` shape of ``configs/recsys_common.py`` (1 M
  candidates, k = 1000);
* ``funnel_config``: the default ``FunnelConfig`` over those two.
"""

from __future__ import annotations

from repro_torch.models.recsys.bst import BSTConfig
from repro_torch.models.recsys.retrieval_tower import TowerConfig
from repro_torch.serving.funnel import FunnelConfig

__all__ = ["bst_model_config", "bst_smoke_config", "tower_config",
           "funnel_config", "RETRIEVAL_CAND"]

#: configs/recsys_common.py RECSYS_SHAPES["retrieval_cand"]
RETRIEVAL_CAND = dict(kind="retrieve", batch=1, n_candidates=1_000_000,
                      k=1000)


def bst_model_config() -> BSTConfig:
    return BSTConfig(embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
                     item_vocab=2_000_000, n_profile=8, mlp=(1024, 512, 256))


def bst_smoke_config() -> BSTConfig:
    return BSTConfig(embed_dim=16, seq_len=6, n_blocks=1, n_heads=4,
                     item_vocab=100, n_profile=4, mlp=(32, 16))


def tower_config() -> TowerConfig:
    return TowerConfig(n_candidates=RETRIEVAL_CAND["n_candidates"])


def funnel_config() -> FunnelConfig:
    """The default ``FunnelConfig``: cutoffs (10, ..., 1000), pool 1000,
    eval depth 50, tau 0.05, RBP p 0.9."""
    return FunnelConfig(tower=tower_config(), bst=bst_model_config())
