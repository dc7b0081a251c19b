"""Plain-torch version of the bag reduction: the JAX package's
``bag_fixed``, with slots added left to right as the kernel adds them."""

from __future__ import annotations

import torch

__all__ = ["embedding_bag_ref"]


def check_shapes(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"embedding_bag takes a (V, D) table and (B, L) "
                         f"ids, got {tuple(table.shape)} and "
                         f"{tuple(ids.shape)}")
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise ValueError(f"ids must be an integer tensor, got {ids.dtype}")


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor, *,
                      mean: bool = False) -> torch.Tensor:
    """table (V, D), ids (B, L) -1 padded -> (B, D); padding slots add
    nothing, ``mean`` divides by max(count, 1)."""
    check_shapes(table, ids)
    mask = ids >= 0
    rows = ids.clamp(min=0).long()
    out = torch.zeros((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    for slot in range(ids.shape[1]):
        out = out + torch.where(mask[:, slot, None], table[rows[:, slot]],
                                zero)
    if mean:
        n = mask.sum(dim=1).clamp(min=1).to(table.dtype)
        out = out / n[:, None]
    return out
