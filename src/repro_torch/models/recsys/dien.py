"""DIEN (Zhou et al., 2018), the Deep Interest Evolution Network: a copy
of the JAX package's ``models/recsys/dien.py``.

Assigned config: embed_dim 18, behavior seq_len 100, GRU dim 108,
MLP 200-80, AUGRU interaction.  Structure:

  behavior ids -> (item + category) embeddings (2 x 18 = 36)
  interest extractor: GRU(36 -> 108) over the sequence (+ auxiliary loss:
      h_t must score the true next behavior above a sampled negative)
  interest evolution: AUGRU(108 -> 108) whose update gate is scaled by
      attention(target, h_t)
  concat(final state, target embedding, user profile) -> MLP 200-80 -> 1.

The reference runs each GRU as a ``jax.lax.scan``; the recurrence is
serial by nature, so here it is a Python loop over T (its ops launch
one after another: 2 x 100 steps at full width, forward and backward).
Padded steps keep the state (``torch.where``), the masked softmax uses
-1e30 in float32, the auxiliary negatives are the batch rolled by one
row, and the MLP's activation is silu, all as the reference has them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import is_dtensor, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.recsys.embedding import gather_rows
from repro_torch.models.recsys.wide_deep import bce

__all__ = ["DIENConfig", "init_dien", "dien_logits", "dien_loss"]


@dataclasses.dataclass(frozen=True)
class DIENConfig:
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    item_vocab: int = 1_000_000
    cat_vocab: int = 10_000
    n_profile: int = 8
    mlp: tuple[int, ...] = (200, 80)
    aux_weight: float = 0.5
    dtype: str = "float32"
    unroll: bool = False   # the JAX dry-run's flag; the loop here is unrolled

    @property
    def tdtype(self) -> torch.dtype:
        return L.torch_dtype(self.dtype)

    @property
    def d_behavior(self) -> int:
        return 2 * self.embed_dim


def _gru_params(rng, d_in, d_h):
    return {
        "wz": L.init_linear(rng, (d_in + d_h, d_h)),
        "wr": L.init_linear(rng, (d_in + d_h, d_h)),
        "wh": L.init_linear(rng, (d_in + d_h, d_h)),
        "bz": np.zeros((d_h,), np.float32), "br": np.zeros((d_h,), np.float32),
        "bh": np.zeros((d_h,), np.float32),
    }


def init_dien(cfg: DIENConfig, seed: int = 0, *, device=None,
              abstract: bool = False) -> dict:
    """Seeded parameters on ``device`` (default ``"cuda"``), equal to the
    JAX package's ``init_dien``: the MLP first, then the tables, the two
    GRUs, the attention and auxiliary maps and the head; with
    ``abstract``, FakeArrays (nothing drawn or placed)."""
    rng = L.rng_or_abstract(seed, abstract)
    d_b = cfg.d_behavior
    d_in = cfg.gru_dim + d_b + cfg.n_profile
    mlp = []
    for h in cfg.mlp:
        mlp.append({"w": L.init_linear(rng, (d_in, h)),
                    "b": np.zeros((h,), np.float32)})
        d_in = h
    tree = {
        "item_table": rng.normal(0, cfg.embed_dim ** -0.5,
                                 (cfg.item_vocab, cfg.embed_dim)
                                 ).astype(np.float32),
        "cat_table": rng.normal(0, cfg.embed_dim ** -0.5,
                                (cfg.cat_vocab, cfg.embed_dim)
                                ).astype(np.float32),
        "gru1": _gru_params(rng, d_b, cfg.gru_dim),
        "augru": _gru_params(rng, cfg.gru_dim, cfg.gru_dim),
        "attn_w": L.init_linear(rng, (d_b, cfg.gru_dim)),
        "aux_w": L.init_linear(rng, (cfg.gru_dim, d_b)),
        "mlp": mlp,
        "head": L.init_linear(rng, (d_in, 1)),
    }
    if abstract:
        return L.abstract_leaves(tree, cfg.tdtype)
    return L.to_device(tree, resolve_device(device), cfg.tdtype)


def _gru_cell(p, x, h, a=None):
    xh = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(xh @ p["wz"] + p["bz"])
    r = torch.sigmoid(xh @ p["wr"] + p["br"])
    xr = torch.cat([x, r * h], dim=-1)
    hh = torch.tanh(xr @ p["wh"] + p["bh"])
    if a is not None:                      # AUGRU: attention scales z
        z = a[:, None] * z
    return (1 - z) * h + z * hh


def _gru(p, xs, mask, attn=None):
    """xs: (B, T, D); mask: (B, T); attn: (B, T) or None -> (last state
    (B, H), states (B, T, H))."""
    if is_dtensor(xs):
        return _gru_sharded(p, xs, mask, attn)
    b, t = xs.shape[0], xs.shape[1]
    h = torch.zeros((b, p["bz"].shape[0]), dtype=xs.dtype, device=xs.device)
    states = []
    for i in range(t):
        hn = _gru_cell(p, xs[:, i], h, None if attn is None else attn[:, i])
        h = torch.where(mask[:, i, None], hn, h)
        states.append(h)
    return h, torch.stack(states, dim=1)


def _gru_sharded(p, xs, mask, attn):
    """``_gru`` on the dry run's DTensors: each device runs the recurrence
    over its own rows of the batch (split over every mesh dim), the
    cell's small weights whole on each; the weights' gradients are
    partial sums over the devices."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = xs.device_mesh
    rows = [Shard(0)] * mesh.ndim

    def local(t):
        return t.redistribute(mesh, rows).to_local()

    pl = {k: w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial()] * mesh.ndim) if is_dtensor(w) else w
        for k, w in p.items()}
    h, states = _gru(pl, local(xs), local(mask),
                     None if attn is None else local(attn))
    b, t = xs.shape[0], xs.shape[1]
    hd = h.shape[-1]
    return (DTensor.from_local(h, mesh, rows, run_check=False,
                               shape=(b, hd), stride=(hd, 1)),
            DTensor.from_local(states, mesh, rows, run_check=False,
                               shape=(b, t, hd), stride=(t * hd, hd, 1)))


def _embed(params, items, cats):
    it = gather_rows(params["item_table"], items.clamp(min=0))
    ct = gather_rows(params["cat_table"], cats.clamp(min=0))
    return torch.cat([it, ct], dim=-1)


def dien_logits(params: dict, cfg: DIENConfig, batch: dict,
                return_aux: bool = False):
    """batch: hist_items/hist_cats (B, T), target_item/target_cat (B,),
    profile (B, n_profile), label (B,).  -1-padded histories.  Returns
    the (B,) float32 logits, and with ``return_aux`` the auxiliary
    loss."""
    eb = _embed(params, batch["hist_items"], batch["hist_cats"])  # (B,T,2E)
    mask = batch["hist_items"] >= 0
    et = _embed(params, batch["target_item"], batch["target_cat"])  # (B,2E)

    _, h1 = _gru(params["gru1"], eb, mask)                        # (B,T,H)

    # attention between target and extractor states
    scores = torch.einsum("bd,bth->bt", et @ params["attn_w"], h1)
    scores = torch.where(mask, scores.to(torch.float32),
                         torch.full((), -1e30, device=scores.device))
    attn = torch.softmax(scores, dim=-1).to(h1.dtype)

    h_final, _ = _gru(params["augru"], h1, mask, attn=attn)

    x = torch.cat([h_final, et, batch["profile"].to(h_final.dtype)], dim=-1)
    for lyr in params["mlp"]:
        x = F.silu(x @ lyr["w"] + lyr["b"])     # DIEN uses dice; silu ~
    logit = (x @ params["head"])[:, 0].to(torch.float32)

    if not return_aux:
        return logit
    if is_dtensor(h1):
        return logit, _aux_sharded(params["aux_w"], h1, eb, mask)
    return logit, _aux_loss(params["aux_w"], h1, eb, mask)


def _aux_loss(aux_w, h1, eb, mask):
    """The auxiliary loss: h_t should score e_{t+1} over a shuffled
    negative (the next behaviour of the previous row)."""
    proj = h1[:, :-1] @ aux_w                                     # (B,T-1,2E)
    nxt = eb[:, 1:]
    pos = torch.einsum("btd,btd->bt", proj, nxt).to(torch.float32)
    neg_e = torch.roll(nxt, 1, dims=0)           # cross-batch negatives
    neg = torch.einsum("btd,btd->bt", proj, neg_e).to(torch.float32)
    m = mask[:, 1:].to(torch.float32)
    aux = -(F.logsigmoid(pos) + F.logsigmoid(-neg)) * m
    return torch.sum(aux) / torch.clamp(torch.sum(m), min=1.0)


def _aux_sharded(aux_w, h1, eb, mask):
    """``_aux_loss`` on the dry run's DTensors: each device over its own
    rows (split over every mesh dim), the negatives rolled within them
    (the global roll moves one row a device to its neighbour, which the
    dry run does not count); the loss is the mean of the devices'."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = h1.device_mesh
    rows = [Shard(0)] * mesh.ndim
    w = aux_w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial()] * mesh.ndim)
    aux = _aux_loss(w, *(t.redistribute(mesh, rows).to_local()
                         for t in (h1, eb, mask)))
    return DTensor.from_local(aux, mesh, [Partial("avg")] * mesh.ndim,
                              run_check=False, shape=(), stride=())


def dien_loss(params: dict, cfg: DIENConfig, batch: dict) -> torch.Tensor:
    logit, aux = dien_logits(params, cfg, batch, return_aux=True)
    return bce(logit, batch["label"]) + cfg.aux_weight * aux
