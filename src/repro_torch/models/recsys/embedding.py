"""Embedding tables and EmbeddingBag for the recsys models.

``gather_rows`` is the row gather every recsys model looks up through
(``jnp.take`` and table indexing in the JAX package), with a
deterministic backward (``scatter_rows``): the ids are sorted stably,
each run of one id summed in a fixed order by ``torch.segment_reduce``,
and the sums written to their distinct rows of a dense zero gradient.
A restarted training run must equal the clean run bit for bit, and the
library's backwards do not promise it: ``index_add_`` adds duplicates
with atomics, and ``index_put_`` with accumulate repeated its bits on
the card only by its implementation's sort, 30x slower at DIEN's
history shape (PERF.md, section 6).  ``bag_fixed`` reduces fixed-size bags
through the ``embedding_bag`` kernel (its CUDA kernel on a CUDA tensor,
its plain version on a CPU tensor; no model calls it); ``bag_ragged``
reduces ragged bags with ``index_add_``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.embedding_bag import ops as eb_ops

__all__ = ["FieldSpec", "init_tables", "gather_rows", "scatter_rows",
           "SCATTER_CHUNK", "lookup", "bag_fixed", "bag_ragged"]


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


#: a run of one id is summed in chunks of this many rows, then the chunk
#: sums in order: one thread adds a run, and DIEN's padding reads row 0
#: some 2.4 M times a step at full width
SCATTER_CHUNK = 1024


def scatter_rows(rows: torch.Tensor, ids: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """The (n_rows, D) sum of ``rows`` (N, D) into rows ``ids`` (N,), in
    an order fixed by the ids alone: a stable sort, an in-order sum of
    each chunk of up to ``SCATTER_CHUNK`` rows of one id, an in-order sum
    of each id's chunk sums, and one write to each distinct row."""
    out = rows.new_zeros((n_rows, rows.shape[1]))
    n = ids.numel()
    if n == 0:
        return out
    sorted_ids, order = torch.sort(ids, stable=True)
    pos = torch.arange(n, device=ids.device)
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    run_start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    chunk_start = first | ((pos - run_start) % SCATTER_CHUNK == 0)
    starts = torch.nonzero(chunk_start).flatten()
    lengths = torch.diff(starts, append=starts.new_full((1,), n))
    sums = torch.segment_reduce(rows[order], "sum", lengths=lengths, axis=0)
    uniq, counts = torch.unique_consecutive(sorted_ids[starts],
                                            return_counts=True)
    out[uniq] = torch.segment_reduce(sums, "sum", lengths=counts, axis=0)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return scatter_rows(grad.contiguous(), ids, ctx.n_rows), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a 2-D ``table`` and ids of any shape, each in
    [0, V): (*ids.shape, D).  Under autograd its backward is
    ``scatter_rows`` (deterministic on the card)."""
    flat = ids.reshape(-1).long()
    if torch.is_grad_enabled() and table.requires_grad:
        rows = _GatherRows.apply(table, flat)
    else:
        rows = table.index_select(0, flat)
    return rows.reshape(*ids.shape, table.shape[1])


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
