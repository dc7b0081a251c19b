"""Plain-torch oracles for impact_scan, identical to retrieval.jass's
``saat_scores`` (static rho) and ``saat_scores_masked`` (per-query rho
vector)."""

from __future__ import annotations

import torch

__all__ = ["impact_scan_ref", "impact_scan_masked_ref"]


def _scatter(docs: torch.Tensor, contrib: torch.Tensor,
             n_docs: int) -> torch.Tensor:
    # jnp.clip(docs, 0) before the scatter, as the reference: -1 would
    # index the last doc in torch
    acc = torch.zeros((docs.shape[0], n_docs), dtype=torch.float32,
                      device=docs.device)
    return acc.scatter_add_(1, docs.clamp(min=0).long(),
                            contrib.to(torch.float32))


def impact_scan_ref(doc_stream: torch.Tensor, impact_stream: torch.Tensor, *,
                    n_docs: int, rho: int) -> torch.Tensor:
    p = doc_stream.shape[-1]
    pos = torch.arange(p, device=doc_stream.device)
    mask = (pos[None, :] < rho) & (doc_stream >= 0)
    contrib = torch.where(mask, impact_stream, torch.zeros_like(impact_stream))
    return _scatter(doc_stream, contrib, n_docs)


def impact_scan_masked_ref(doc_stream: torch.Tensor,
                           impact_stream: torch.Tensor,
                           rho_vec: torch.Tensor, *,
                           n_docs: int) -> torch.Tensor:
    """Per-query rho: accumulate the first ``rho_vec[q]`` postings."""
    p = doc_stream.shape[-1]
    pos = torch.arange(p, device=doc_stream.device)
    mask = (pos[None, :] < rho_vec[:, None]) & (doc_stream >= 0)
    contrib = torch.where(mask, impact_stream, torch.zeros_like(impact_stream))
    return _scatter(doc_stream, contrib, n_docs)
