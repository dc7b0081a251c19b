"""Embedding tables and EmbeddingBag for the recsys models.

Every recsys model looks its rows up through ``gather_rows``
(``jnp.take`` and table indexing in the JAX package), which lives in
``models.layers`` beside the LM's token embedding that reads through it
too, with its deterministic backward ``scatter_rows``; both are
re-exported here.  ``bag_fixed`` reduces fixed-size bags through the
``embedding_bag`` kernel (its CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor; no model calls it); ``bag_ragged`` reduces
ragged bags with ``index_add_``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.models.layers import gather_rows, scatter_rows

__all__ = ["FieldSpec", "init_tables", "gather_rows", "scatter_rows",
           "lookup", "bag_fixed", "bag_ragged"]


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    vocab: int
    dim: int
    bag: int = 1          # >1: multi-hot field reduced by sum/mean
    combiner: str = "sum"  # "sum" | "mean"


def init_tables(fields: tuple[FieldSpec, ...], seed: int = 0,
                dtype=np.float32) -> dict[str, np.ndarray]:
    """One (vocab, dim) normal(0, dim**-0.5) table per field, drawn in
    field order (numpy arrays; ``layers.to_device`` moves them)."""
    rng = np.random.default_rng(seed)
    return {
        f.name: (rng.normal(0, f.dim ** -0.5, (f.vocab, f.dim))
                 .astype(dtype))
        for f in fields
    }


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-id lookup: (B,) -> (B, D); -1 reads row 0."""
    return gather_rows(table, ids.clamp(min=0))


def bag_fixed(table: torch.Tensor, ids: torch.Tensor,
              combiner: str = "sum") -> torch.Tensor:
    """EmbeddingBag over fixed-size bags.  ids: (B, L), -1 padded ->
    (B, D), through the ``embedding_bag`` kernel."""
    return eb_ops.embedding_bag(table, ids, combiner=combiner)


def bag_ragged(table: torch.Tensor, flat_ids: torch.Tensor,
               segment_ids: torch.Tensor, n_bags: int,
               combiner: str = "sum") -> torch.Tensor:
    """EmbeddingBag over ragged bags.  flat_ids: (T,) all ids
    concatenated; segment_ids: (T,) bag of each id."""
    e = table[flat_ids.clamp(min=0).long()]
    valid = (flat_ids >= 0)[:, None].to(e.dtype)
    seg = segment_ids.long()
    s = torch.zeros((n_bags, table.shape[1]), dtype=e.dtype,
                    device=e.device).index_add_(0, seg, e * valid)
    if combiner == "mean":
        n = torch.zeros((n_bags,), dtype=e.dtype,
                        device=e.device).index_add_(0, seg, valid[:, 0])
        s = s / n.clamp(min=1.0)[:, None]
    return s
