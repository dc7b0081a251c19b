"""Two-tower retrieval and bulk candidate scoring (stage 1 of the funnel).

A user tower embeds the request, and each request is scored against
``n_candidates`` item embeddings as one matrix product and a top-k.
The products are plain ``torch.matmul`` (the JAX package leaves them to
XLA).  The top-k selects what ``jax.lax.top_k`` selects, in its order:
descending score, ``+0.0`` above ``-0.0``, and ties to the lower id, at
the k-th boundary too.  ``tower_loss`` is the training loss: an
in-batch softmax over the positive items (``F.cross_entropy`` over the
(B, B) logits, the reference's mean of ``-log_softmax`` at the
diagonal).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import is_fake, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.recsys.embedding import gather_rows

__all__ = ["TowerConfig", "init_tower", "user_embed", "score_candidates",
           "top_k", "retrieve_topk", "tower_loss"]


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


def _draw_tower(cfg: TowerConfig, rng) -> dict:
    """The parameter tree as float32 numpy arrays, drawn in the JAX
    package's order (MLP layers, then the item table)."""
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


def init_tower(cfg: TowerConfig, seed: int = 0, *, device=None,
               abstract: bool = False) -> dict:
    """Seeded parameters on ``device`` (default ``"cuda"``), equal to the
    JAX package's ``init_tower`` for the same seed; with ``abstract``,
    FakeArrays (nothing drawn or placed)."""
    tree = _draw_tower(cfg, L.rng_or_abstract(seed, abstract))
    if abstract:
        return L.abstract_leaves(tree, cfg.tdtype)
    return L.to_device(tree, resolve_device(device), cfg.tdtype)


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


def _keys(scores: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 keys of float32 scores: the bits, with the
    magnitude bits flipped where the sign is set (``-0.0`` keys below
    ``+0.0``)."""
    bits = scores.view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _top_k_keyed(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The ids ``top_k`` selects, by one ``torch.topk`` over distinct
    int64 keys: the score's key in the high half, the flipped id in the
    low half."""
    n = scores.shape[1]
    key = _keys(scores).to(torch.int64)
    key <<= 32
    key |= torch.arange(n - 1, -1, -1, dtype=torch.int64,
                        device=scores.device)
    return (n - 1) - (torch.topk(key, k, dim=1).values & 0xFFFFFFFF)


def top_k(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` of (B, N) float32 scores: ids (int64) and values
    of the k largest per row, descending, ``+0.0`` above ``-0.0``, ties
    to the lower id (at the k-th boundary too).

    A float32 ``torch.topk`` of k + 1 selects exactly unless the
    (k+1)-th score equals the k-th (``-0.0`` and ``+0.0`` compare equal,
    so a zero left out counts): only then may a tie be cut at the
    boundary, and ``_top_k_keyed`` selects again.  A blocking read of
    one flag from the card decides, so every call on a CUDA tensor
    waits for the card there (a sync on the funnel's stage 1, which
    stops the call from being captured in a CUDA graph).  The selection
    is then ordered by key, ties to the lower id."""
    n = scores.shape[1]
    vals, idx = torch.topk(scores, min(k + 1, n), dim=1)
    # a fake tensor (the dry run's) has no values to tie: the plain order
    if (0 < k < n and not is_fake(scores)
            and bool((vals[:, k] == vals[:, k - 1]).any())):
        idx = _top_k_keyed(scores, k)
    else:
        idx = idx[:, :k]
        idx = idx.gather(1, torch.sort(idx, dim=1, stable=True).indices)
        order = torch.sort(_keys(scores.gather(1, idx)), dim=1,
                           descending=True, stable=True).indices
        idx = idx.gather(1, order)
    return idx, scores.gather(1, idx)


def retrieve_topk(params: dict, cfg: TowerConfig, user_feats: torch.Tensor,
                  k: int):
    """Candidate generation: top-k item ids (int32) and scores per
    request, as ``jax.lax.top_k`` gives them (``top_k``)."""
    idx, vals = top_k(score_candidates(params, cfg, user_feats), k)
    return idx.to(torch.int32), vals


def tower_loss(params: dict, cfg: TowerConfig, batch: dict) -> torch.Tensor:
    """In-batch softmax over positive items.  batch: user_feats (B, d),
    pos_item (B,) ids into the candidate table."""
    u = user_embed(params, cfg, batch["user_feats"])
    pos = gather_rows(params["items"], batch["pos_item"].clamp(min=0))
    logits = (u @ pos.T).to(torch.float32)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels)
