"""EmbeddingBag wrapper: the combiner's name onto the kernel's flag."""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import kernel as _kernel_mod

__all__ = ["embedding_bag"]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, *,
                  combiner: str = "sum") -> torch.Tensor:
    """table (V, D), ids (B, L) -1-padded -> (B, D).

    Launches the CUDA kernel on a CUDA tensor and its plain version on a
    CPU tensor."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', got "
                         f"{combiner!r}")
    return _kernel_mod.embedding_bag_kernel(table, ids,
                                            mean=combiner == "mean")
