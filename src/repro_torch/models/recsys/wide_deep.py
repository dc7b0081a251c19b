"""Wide & Deep (Cheng et al., 2016), a copy of the JAX package's
``models/recsys/wide_deep.py``: 40 sparse fields, embed_dim 32, deep MLP
1024-512-256, concat interaction.

Wide part: per-field dim-1 embeddings (the sparse linear term over
one-hots) plus hashed cross-feature ids supplied by the pipeline.  Deep
part: concat(field embeddings, dense features) -> MLP -> logit.  Every
table is read through ``embedding.gather_rows`` (a deterministic
backward), the (F, V, D) deep table as F * V rows.

At full width the deep table is (40, 1 000 000, 32) float32, 5.12 GB.
The JAX ``init_wide_deep`` draws it as one float64 ``rng.normal`` (about
10 GB of host memory before the cast); here it is drawn field by field,
each (V, D) slab cast and copied to the device on the way.  Consecutive
``Generator.normal`` calls continue one stream, so the values are the
JAX draw's bit for bit with a host peak of one slab.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.recsys.embedding import gather_rows

__all__ = ["WideDeepConfig", "init_wide_deep", "wide_deep_logits", "bce",
           "wide_deep_loss"]


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    n_sparse: int = 40
    n_dense: int = 13
    n_cross: int = 8                  # hashed cross-product wide features
    embed_dim: int = 32
    vocab_per_field: int = 1_000_000
    cross_vocab: int = 100_000
    mlp: tuple[int, ...] = (1024, 512, 256)
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return L.torch_dtype(self.dtype)


def init_wide_deep(cfg: WideDeepConfig, seed: int = 0, *,
                   device=None, abstract: bool = False) -> dict:
    """Seeded parameters on ``device`` (default ``"cuda"``), equal to the
    JAX package's ``init_wide_deep`` for the same seed: the deep table
    field by field, then the MLP, the head and the wide dense weights;
    with ``abstract``, FakeArrays (nothing drawn or placed)."""
    dt = cfg.tdtype
    shape = (cfg.vocab_per_field, cfg.embed_dim)
    if abstract:
        return _abstract_wide_deep(cfg, dt, shape)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    deep_table = torch.empty((cfg.n_sparse, *shape), dtype=dt, device=dev)
    for f in range(cfg.n_sparse):
        deep_table[f] = torch.from_numpy(
            rng.normal(0, cfg.embed_dim ** -0.5, shape).astype(np.float32))
    d_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    mlp = []
    for h in cfg.mlp:
        mlp.append({"w": L.init_linear(rng, (d_in, h)),
                    "b": np.zeros((h,), np.float32)})
        d_in = h
    rest = L.to_device({
        "wide_table": np.zeros((cfg.n_sparse, cfg.vocab_per_field),
                               np.float32),
        "cross_table": np.zeros((cfg.n_cross, cfg.cross_vocab), np.float32),
        "mlp": mlp,
        "head": L.init_linear(rng, (d_in, 1)),
        "wide_dense": L.init_linear(rng, (cfg.n_dense, 1)),
        "bias": np.zeros((1,), np.float32),
    }, dev, dt)
    return {"deep_table": deep_table, **rest}


def _abstract_wide_deep(cfg: WideDeepConfig, dt, shape) -> dict:
    rng = L.AbstractRNG()
    d_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    mlp = []
    for h in cfg.mlp:
        mlp.append({"w": L.init_linear(rng, (d_in, h)),
                    "b": L.FakeArray((h,), dt)})
        d_in = h
    return L.abstract_leaves({
        "deep_table": L.FakeArray((cfg.n_sparse, *shape), dt),
        "wide_table": L.FakeArray((cfg.n_sparse, cfg.vocab_per_field), dt),
        "cross_table": L.FakeArray((cfg.n_cross, cfg.cross_vocab), dt),
        "mlp": mlp,
        "head": L.init_linear(rng, (d_in, 1)),
        "wide_dense": L.init_linear(rng, (cfg.n_dense, 1)),
        "bias": L.FakeArray((1,), dt),
    }, dt)


def _field_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[f, ids[:, f]]`` for a (F, V, ...) table and (B, F) ids:
    (B, F, ...), read as rows of the (F * V, ...) table."""
    n_f, v = table.shape[0], table.shape[1]
    rows = table.reshape(n_f * v, -1)
    off = torch.arange(n_f, device=ids.device) * v
    out = gather_rows(rows, ids.long() + off[None, :])
    return out.reshape(*ids.shape, *table.shape[2:])


def wide_deep_logits(params: dict, cfg: WideDeepConfig,
                     batch: dict) -> torch.Tensor:
    """batch: sparse_ids (B, F), cross_ids (B, Fx), dense (B, n_dense) ->
    (B,) float32 logits."""
    ids = batch["sparse_ids"].clamp(min=0)                  # (B, F)
    emb = _field_rows(params["deep_table"], ids)            # (B, F, D)
    b = ids.shape[0]
    dense = batch["dense"].to(emb.dtype)
    x = torch.cat([emb.reshape(b, -1), dense], dim=-1)
    for lyr in params["mlp"]:
        x = torch.relu(x @ lyr["w"] + lyr["b"])
    deep = x @ params["head"]
    wide = _field_rows(params["wide_table"], ids).sum(-1, keepdim=True)
    cx = batch["cross_ids"].clamp(min=0)
    wide = wide + _field_rows(params["cross_table"], cx).sum(-1,
                                                             keepdim=True)
    wide = wide + dense @ params["wide_dense"]
    return (deep + wide + params["bias"])[:, 0].to(torch.float32)


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    z = logits
    y = labels.to(torch.float32)
    return torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def wide_deep_loss(params: dict, cfg: WideDeepConfig,
                   batch: dict) -> torch.Tensor:
    return bce(wide_deep_logits(params, cfg, batch), batch["label"])
