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

from repro_torch.device import is_dtensor, resolve_device
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
    low half.  The plain form ``top_k`` is held against (it moves 1 GB
    of keys at (128, 1 M))."""
    n = scores.shape[1]
    key = _keys(scores).to(torch.int64)
    key <<= 32
    key |= torch.arange(n - 1, -1, -1, dtype=torch.int64,
                        device=scores.device)
    return (n - 1) - (torch.topk(key, k, dim=1).values & 0xFFFFFFFF)


#: entries a block in ``_first_set``'s coarse pass
_BLOCK = 32
_INT32_MIN = torch.iinfo(torch.int32).min


def _first_set(has: torch.Tensor, entries, k: int) -> torch.Tensor:
    """The first ``k`` set entries of each row, as positions ``block *
    _BLOCK + offset`` in block order (``nb * _BLOCK`` past a row's last
    one).  ``has`` (B, nb) marks the blocks of ``_BLOCK`` entries that
    hold one, ``entries(blk)`` gives the entries (B, kb, ``_BLOCK``) of
    the blocks ``blk`` (B, kb).

    Two top-k's over distinct priorities, fixed shapes throughout: the
    first ``k`` blocks that hold a set entry (they hold the first ``k``
    set entries), then the first ``k`` set entries of those blocks,
    gathered in block order."""
    b, nb = has.shape
    dev = has.device
    kb = min(k, nb)
    # priority nb - block: the lowest blocks holding an entry come first
    bprio = torch.where(has, torch.arange(nb, 0, -1, dtype=torch.int32,
                                          device=dev), 0)
    btop = torch.topk(bprio, kb, dim=1).values.to(torch.int64)
    blk = (nb - btop).clamp(max=nb - 1)
    sub = entries(blk) & (btop > 0)[:, :, None]
    m = kb * _BLOCK
    eprio = torch.where(sub.reshape(b, m),
                        torch.arange(m, 0, -1, dtype=torch.int32,
                                     device=dev), 0)
    etop = torch.topk(eprio, min(k, m), dim=1).values.to(torch.int64)
    pos = m - etop.clamp(min=1)
    first = blk.gather(1, pos // _BLOCK) * _BLOCK + pos % _BLOCK
    first = torch.where(etop > 0, first, nb * _BLOCK)
    if first.shape[1] < k:
        first = F.pad(first, (0, k - first.shape[1]), value=nb * _BLOCK)
    return first


def _gather_blocks(x: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """The blocks ``blk`` (B, kb) of ``x`` (B, nb, ``_BLOCK``)."""
    return x.gather(1, blk[:, :, None].expand(*blk.shape, _BLOCK))


def _class_blocks(bits: torch.Tensor, pattern: torch.Tensor):
    """The scores of one bit ``pattern`` (B, 1) among ``bits`` (B, nb *
    ``_BLOCK``): their flags (B, nb, ``_BLOCK``), and which blocks hold
    one.  A block holds one where one of the four 8-byte words its flags
    fill is not zero (a reduction over the flags themselves is several
    times slower on the card)."""
    b, n = bits.shape
    nb = n // _BLOCK
    eq = bits == pattern
    has = eq.view(torch.int64).view(b, nb, _BLOCK // 8).sum(dim=2) != 0
    return eq.view(b, nb, _BLOCK), has


def top_k(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` of (B, N) float32 scores: ids (int64) and values
    of the k largest per row, descending, ``+0.0`` above ``-0.0``, ties
    to the lower id (at the k-th boundary too).

    No host read and no shape that depends on the data, so the call is
    the same eagerly, inside a captured CUDA graph and on the dry run's
    fake tensors.  A float32 ``torch.topk`` gives the k largest values
    and so the k-th value ``t``; every score above ``t`` is among its
    picks.  The rest of the selection is the first of the scores equal
    to ``t`` in key order, then id order: the upper class, the scores
    with the bit pattern of ``t`` (``+0.0`` where ``t`` is a zero), then,
    where ``t`` is a zero, the lower class, the ``-0.0`` scores.  Each
    class costs one pass that compares every score; ``_first_set`` takes
    the first ties over the upper class's blocks followed by the lower
    class's.  The selection is then ordered by key, ties to the lower
    id."""
    if is_dtensor(scores):
        # the dry run's: each device takes the rows whole (one gather)
        from torch.distributed.tensor import Replicate
        mesh = scores.device_mesh
        scores = scores.redistribute(mesh, [Replicate()] * mesh.ndim)
    b, n = scores.shape
    vals, idx = torch.topk(scores, k, dim=1)
    t = vals[:, k - 1:k]
    n_gt = (vals > t).sum(dim=1, keepdim=True)
    zero = t == 0
    t_bits = t.contiguous().view(torch.int32)
    bits = scores.contiguous().view(torch.int32)
    nb = -(-n // _BLOCK)
    if nb * _BLOCK != n:          # a NaN's pattern, of neither class
        bits = torch.cat([bits, bits.new_full((b, nb * _BLOCK - n),
                                              torch.iinfo(torch.int32).max)],
                         dim=1)
    eq_up, has_up = _class_blocks(bits, torch.where(zero, 0, t_bits))
    eq_lo, has_lo = _class_blocks(bits, torch.where(zero, _INT32_MIN,
                                                    t_bits))

    def entries(blk):             # blocks nb.. are the lower class's
        up = blk < nb
        return torch.where(up[:, :, None],
                           _gather_blocks(eq_up, torch.where(up, blk, 0)),
                           _gather_blocks(eq_lo, torch.where(up, 0,
                                                             blk - nb)))

    ties = _first_set(torch.cat([has_up, has_lo & zero], dim=1), entries,
                      k) % (nb * _BLOCK)
    # slot j: the j-th score above t (vals is descending), then the
    # (j - n_gt)-th tie
    j = torch.arange(k, device=scores.device)[None, :]
    idx = torch.where(j < n_gt, idx, ties.gather(
        1, (j - n_gt).clamp(min=0)))
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
