"""EmbeddingBag over fixed-size bags: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``embedding_bag_kernel`` of
``src/repro/kernels/embedding_bag/kernel.py``; the CUDA source is
``src/repro_torch/csrc/embedding_bag.cu``, whose header gives the design
(a lane group of a warp per bag, 16-byte row reads, sums in registers)
and the bound (bytes: the gathered rows, the ids and the output).

Slots are added left to right, as the TPU kernel's grid adds them;
padding slots (-1) add nothing, ``mean`` divides by max(count, 1), and a
bag of padding only gives zeros.  The table is float32 or bfloat16 and
the output takes its type; a bfloat16 sum is rounded after every add, as
the Pallas kernel accumulates in the output's type.  ``embedding_bag_kernel`` launches the
kernel on a CUDA tensor and runs ``ref.embedding_bag_ref`` (the same slot
order in plain torch) on a CPU tensor; ``n_launches`` counts launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag.ref import (check_shapes,
                                                   embedding_bag_ref)

__all__ = ["embedding_bag_kernel", "n_launches"]

#: kernel launches since the last reset
n_launches = 0

#: the table dtypes the kernel takes, and the launcher's code of each
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def embedding_bag_kernel(table: torch.Tensor, ids: torch.Tensor, *,
                         mean: bool = False) -> torch.Tensor:
    """table: (V, D) float32 or bfloat16; ids: (B, L) integer, -1 padded,
    each in [-1, V) -> (B, D) in the table's dtype."""
    global n_launches
    _build.check_no_grad("embedding_bag", table)
    dev = table.device
    if dev.type == "cpu":
        return embedding_bag_ref(table, ids, mean=mean)
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag runs on cuda or cpu, not {dev}")
    check_shapes(table, ids)
    if table.dtype not in _DTYPES:
        raise ValueError(f"the embedding_bag kernel takes a float32 or "
                         f"bfloat16 table, got {table.dtype}")
    if ids.device != dev:
        raise ValueError("table and ids must be on one device")
    t = table.contiguous()
    i = ids.to(torch.int32).contiguous()
    bsz, n_slots = i.shape
    d = t.shape[1]
    out = torch.empty((bsz, d), dtype=t.dtype, device=dev)
    wide = int(d * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0)
    launch = _build.library("embedding_bag")
    err = launch(t.data_ptr(), i.data_ptr(), out.data_ptr(), bsz, n_slots, d,
                 wide, _DTYPES[t.dtype], int(mean), _build.stream(dev))
    _build.check(err, "embedding_bag")
    if not _build.counted_in_capture(__name__):
        n_launches += 1
    return out
