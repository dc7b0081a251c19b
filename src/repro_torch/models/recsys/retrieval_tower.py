"""Two-tower retrieval and bulk candidate scoring (stage 1 of the funnel).

A user tower embeds the request, and each request is scored against
``n_candidates`` item embeddings as one matrix product and a top-k.
The products are plain ``torch.matmul`` (the JAX package leaves them to
XLA); the top-k is ``torch.topk`` followed by a stable re-sort of the
selected (value, index) pairs, descending value and ties to the lower
index, which is ``jax.lax.top_k``'s order.  What remains open at the
k-th boundary: where several items tie with the k-th score,
``torch.topk`` may select any of them, and ``jax.lax.top_k`` the lowest
indices.  ``tower_loss`` waits for the training slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L

__all__ = ["TowerConfig", "init_tower", "user_embed", "score_candidates",
           "retrieve_topk"]


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    d_user_in: int = 64
    embed_dim: int = 64
    hidden: tuple[int, ...] = (256, 128)
    n_candidates: int = 1_000_000
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return L.torch_dtype(self.dtype)


def _draw_tower(cfg: TowerConfig, seed: int) -> dict:
    """The parameter tree as float32 numpy arrays, drawn in the JAX
    package's order (MLP layers, then the item table)."""
    rng = np.random.default_rng(seed)
    d_in = cfg.d_user_in
    mlp = []
    for h in (*cfg.hidden, cfg.embed_dim):
        mlp.append({"w": L.init_linear(rng, (d_in, h)),
                    "b": np.zeros((h,), np.float32)})
        d_in = h
    return {
        "mlp": mlp,
        "items": rng.normal(0, cfg.embed_dim ** -0.5,
                            (cfg.n_candidates, cfg.embed_dim)
                            ).astype(np.float32),
    }


def init_tower(cfg: TowerConfig, seed: int = 0, *, device=None) -> dict:
    """Seeded parameters on ``device`` (default ``"cuda"``), equal to the
    JAX package's ``init_tower`` for the same seed."""
    return L.to_device(_draw_tower(cfg, seed), resolve_device(device),
                       cfg.tdtype)


def user_embed(params: dict, cfg: TowerConfig,
               user_feats: torch.Tensor) -> torch.Tensor:
    x = user_feats.to(cfg.tdtype)
    for i, lyr in enumerate(params["mlp"]):
        x = x @ lyr["w"] + lyr["b"]
        if i + 1 < len(params["mlp"]):
            x = torch.relu(x)
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp(min=1e-6)


def score_candidates(params: dict, cfg: TowerConfig,
                     user_feats: torch.Tensor) -> torch.Tensor:
    """(B, d_user_in) -> (B, n_candidates) dot-product scores."""
    u = user_embed(params, cfg, user_feats)
    return (u @ params["items"].T).to(torch.float32)


def retrieve_topk(params: dict, cfg: TowerConfig, user_feats: torch.Tensor,
                  k: int):
    """Candidate generation: top-k item ids (int32) and scores per
    request, descending score, ties to the lower id."""
    scores = score_candidates(params, cfg, user_feats)
    vals, idx = torch.topk(scores, k, dim=1)
    # make the order explicit: a stable sort by id, then a stable sort
    # by descending score
    by_id = torch.sort(idx, dim=1, stable=True).indices
    vals, idx = vals.gather(1, by_id), idx.gather(1, by_id)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return idx.gather(1, order).to(torch.int32), vals.gather(1, order)
