"""Uniform fanout neighbour sampler (GraphSAGE minibatch training): the
JAX package's ``models/sampler.py`` on tensors.

Given an in-neighbour CSR, ``sample_blocks`` draws ``fanout`` uniform
neighbours (with replacement, per GraphSAGE) for every frontier node,
layer by layer, and emits the block structure that
``models.gnn.sage_forward_blocks`` consumes.  Isolated nodes (degree 0)
self-loop.  The frontiers are dense and static-shaped, as the
reference's: ``prod(fanouts[:i+1]) * n_seeds`` nodes at hop ``i + 1``.

The random bits come from a ``torch.Generator`` on the tensors' device,
so they are not JAX's; ``pick_neighbours`` is the one step that maps
the bits ``r`` in [0, 2^30) to neighbours, and fed numpy's bits it gives
``sample_blocks_np``'s frontiers.  ``csr_from_edges`` builds the CSR on
the host (numpy, as the reference) or, given a ``device``, on that
device with a stable sort, whose one answer is numpy's: at Reddit scale
(114.6 M edges) the host's stable argsort takes many seconds.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["csr_from_edges", "pick_neighbours", "sample_blocks",
           "sample_blocks_np"]


def csr_from_edges(edges, n_nodes: int, device=None):
    """(2, E) [src, dst] -> in-neighbour CSR (indptr int64, indices
    int32): numpy arrays, or tensors on ``device`` when one is given."""
    if device is None:
        src, dst = edges
        order = np.argsort(dst, kind="stable")
        indices = src[order].astype(np.int32)
        counts = np.bincount(dst, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return indptr, indices
    e = torch.as_tensor(edges).to(device)
    sorted_dst, order = torch.sort(e[1], stable=True)
    indices = e[0][order].to(torch.int32)
    # the run of node i starts where the sorted ids first reach i
    bounds = torch.arange(n_nodes + 1, dtype=sorted_dst.dtype,
                          device=sorted_dst.device)
    indptr = torch.searchsorted(sorted_dst, bounds)
    return indptr, indices


def pick_neighbours(r: torch.Tensor, cur: torch.Tensor, indptr: torch.Tensor,
                    indices: torch.Tensor) -> torch.Tensor:
    """The (n, f) neighbours of frontier ``cur`` (n,) for the bits ``r``
    (n, f) in [0, 2^30): ``indices[lo + r % max(deg, 1)]``, the pick
    clipped into ``indices``, and ``cur`` itself where the degree is 0."""
    cur = cur.long()
    lo, hi = indptr[cur], indptr[cur + 1]
    deg = hi - lo
    pick = lo[:, None] + r % deg.clamp(min=1)[:, None]
    neigh = indices[pick.clamp(0, indices.shape[0] - 1)]
    return torch.where(deg[:, None] > 0, neigh.to(torch.int32),
                       cur[:, None].to(torch.int32))


def _block(n: int, f: int, device) -> dict:
    ar = torch.arange(n * f, dtype=torch.int32, device=device)
    return {"src_index": ar, "dst_index": ar // f, "n_dst": n}


def sample_blocks(generator: torch.Generator, indptr: torch.Tensor,
                  indices: torch.Tensor, seeds: torch.Tensor,
                  fanouts: tuple[int, ...]):
    """Layered fanout sampling on the tensors' device.

    Returns (frontiers, blocks): frontiers[0] = seeds (int32),
    frontiers[i+1] the sampled neighbours of frontier i; blocks[i] =
    {"src_index", "dst_index", "n_dst"}, frontier indices in the format
    of ``sage_forward_blocks``."""
    dev = indices.device
    frontiers = [seeds.to(torch.int32)]
    blocks = []
    for f in fanouts:
        cur = frontiers[-1]
        n = cur.shape[0]
        r = torch.randint(0, 1 << 30, (n, f), generator=generator,
                          device=dev)
        frontiers.append(pick_neighbours(r, cur, indptr, indices).reshape(-1))
        blocks.append(_block(n, f, dev))
    return frontiers, blocks


def sample_blocks_np(rng: np.random.Generator, indptr: np.ndarray,
                     indices: np.ndarray, seeds: np.ndarray,
                     fanouts: tuple[int, ...]):
    """Host twin of sample_blocks (for prefetch workers)."""
    frontiers = [seeds.astype(np.int32)]
    blocks = []
    for f in fanouts:
        cur = frontiers[-1]
        n = len(cur)
        lo, hi = indptr[cur], indptr[cur + 1]
        deg = (hi - lo).astype(np.int64)
        r = rng.integers(0, 1 << 30, size=(n, f))
        pick = lo[:, None] + (r % np.maximum(deg, 1)[:, None])
        neigh = indices[np.clip(pick, 0, len(indices) - 1)]
        neigh = np.where(deg[:, None] > 0, neigh, cur[:, None])
        frontiers.append(neigh.reshape(-1).astype(np.int32))
        blocks.append({
            "src_index": np.arange(n * f, dtype=np.int32),
            "dst_index": np.repeat(np.arange(n, dtype=np.int32), f),
            "n_dst": n,
        })
    return frontiers, blocks
