"""MIND (Li et al., 2019), the Multi-Interest Network with Dynamic
Routing: a copy of the JAX package's ``models/recsys/mind.py``.

Assigned config: embed_dim 64, n_interests 4, capsule routing iters 3.
Behavior embeddings are routed into K interest capsules (B2I dynamic
routing with a shared bilinear map and squash nonlinearity); training uses
label-aware attention over the interests + sampled-softmax against
in-batch negatives; serving scores a target item against the max-scoring
interest.  The routing reads the behaviours through ``.detach()`` (the
reference's ``jax.lax.stop_gradient``) except in its last iteration.
The in-batch softmax loss is ``F.cross_entropy`` over the (B, B)
logits: the reference's mean of ``-log_softmax`` at the diagonal,
without keeping a second (B, B) tensor for the pick.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.recsys.embedding import gather_rows

__all__ = ["MINDConfig", "init_mind", "mind_interests", "mind_loss",
           "mind_score"]


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    item_vocab: int = 1_000_000
    pow_p: float = 2.0            # label-aware attention sharpness
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return L.torch_dtype(self.dtype)


def init_mind(cfg: MINDConfig, seed: int = 0, *, device=None,
              abstract: bool = False) -> dict:
    """Seeded parameters on ``device`` (default ``"cuda"``), equal to the
    JAX package's ``init_mind`` for the same seed; with ``abstract``,
    FakeArrays (nothing drawn or placed)."""
    rng = L.rng_or_abstract(seed, abstract)
    d = cfg.embed_dim
    tree = {
        "item_table": rng.normal(0, d ** -0.5,
                                 (cfg.item_vocab, d)).astype(np.float32),
        "bilinear": L.init_linear(rng, (d, d)),
        # fixed (per-user-random in paper; shared learnable here) routing init
        "routing_init": rng.normal(0, 1.0, (cfg.seq_len, cfg.n_interests)
                                   ).astype(np.float32),
    }
    if abstract:
        return L.abstract_leaves(tree, cfg.tdtype)
    return L.to_device(tree, resolve_device(device), cfg.tdtype)


def _squash(v: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * v / torch.sqrt(n2 + 1e-9)


def mind_interests(params: dict, cfg: MINDConfig,
                   hist_items: torch.Tensor) -> torch.Tensor:
    """hist_items: (B, T) -1-padded -> interest capsules (B, K, D)."""
    mask = hist_items >= 0
    e = gather_rows(params["item_table"], hist_items.clamp(min=0))
    u_hat = e @ params["bilinear"]                   # (B, T, D)
    u_hat = u_hat * mask[..., None].to(u_hat.dtype)
    b, t = hist_items.shape
    b_logit = params["routing_init"][None, :t, :].expand(
        b, t, cfg.n_interests)                       # (B, T, K)
    u_sg = u_hat.detach()                            # routing uses sg (paper)
    neg = torch.full((), -1e30, device=u_hat.device)
    for it in range(cfg.capsule_iters):
        w = torch.softmax(torch.where(mask[..., None],
                                      b_logit.to(torch.float32), neg),
                          dim=-1)                    # over K
        src = u_hat if it == cfg.capsule_iters - 1 else u_sg
        z = torch.einsum("btk,btd->bkd", w.to(src.dtype), src)
        v = _squash(z)                               # (B, K, D)
        if it < cfg.capsule_iters - 1:
            b_logit = b_logit + torch.einsum("btd,bkd->btk", u_sg, v)
    return v


def mind_score(params: dict, cfg: MINDConfig, interests: torch.Tensor,
               target_e: torch.Tensor) -> torch.Tensor:
    """Serving score = max over interests of <v_k, e_target>."""
    s = torch.einsum("bkd,bd->bk", interests, target_e)
    return torch.max(s, dim=-1).values.to(torch.float32)


def mind_loss(params: dict, cfg: MINDConfig, batch: dict) -> torch.Tensor:
    """Label-aware attention + in-batch sampled softmax.

    batch: hist_items (B, T), target_item (B,).
    """
    v = mind_interests(params, cfg, batch["hist_items"])     # (B, K, D)
    et = gather_rows(params["item_table"],
                     batch["target_item"].clamp(min=0))      # (B, D)
    att = torch.softmax(
        torch.einsum("bkd,bd->bk", v, et).to(torch.float32) * cfg.pow_p,
        dim=-1)
    user = torch.einsum("bk,bkd->bd", att.to(v.dtype), v)    # (B, D)
    # in-batch sampled softmax: logits over the batch's targets
    logits = (user @ et.T).to(torch.float32)                 # (B, B)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels)
