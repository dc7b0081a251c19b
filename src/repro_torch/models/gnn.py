"""GraphSAGE (Hamilton et al., 2017), mean aggregator: the JAX package's
``models/gnn.py`` on tensors.

Aggregation gathers source features by edge index and sums them into
their destinations, divided by the in-degree, as the reference's
``jax.ops.segment_sum`` does.  On the card a scatter-add has no fixed
order of adds (``index_add_`` uses atomics), so the sum goes through
``layers.scatter_rows``, whose order is fixed by the ids alone, with a
backward that gathers the gradient back (``index_select``); the gather
of ``h[src]`` is ``layers.gather_rows``, whose backward is that same
fixed-order sum.  Two runs of a step give the same bits.  The products
are plain ``@``, as the reference's.

Two execution modes, as the reference's: full-batch over one (2, E)
edge list (``sage_forward_full``), and sampled minibatches over the
layered blocks of ``models.sampler`` (``sage_forward_blocks``); plus the
molecule cell's graph regression over a batch of small graphs.

The L2 normalisation after each layer's ``relu`` divides by
``max(norm, 1e-6)``.  On a row that ``relu`` zeroes entirely the
reference's ``jnp.linalg.norm`` has a NaN gradient and torch's
``vector_norm`` a zero one; in both, ``relu``'s backward masks the row,
so the parameters' gradients are equal (``tests/test_torch_gnn.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L

__all__ = ["SageConfig", "init_sage", "segment_sum", "sage_forward_full",
           "sage_forward_blocks", "sage_loss_full", "sage_loss_blocks",
           "sage_graph_regression", "sage_loss_molecule"]


@dataclasses.dataclass(frozen=True)
class SageConfig:
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    n_classes: int = 41
    aggregator: str = "mean"
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return L.torch_dtype(self.dtype)


def init_sage(cfg: SageConfig, seed: int = 0, *, device=None,
              abstract: bool = False) -> dict:
    """Seeded parameters on ``device`` (default ``"cuda"``), equal to the
    JAX package's ``init_sage`` for the same seed (the same numpy draws,
    in its order).  With ``abstract`` every drawn leaf is a
    ``layers.FakeArray`` and nothing is placed."""
    rng = L.rng_or_abstract(seed, abstract)
    layers = []
    d_in = cfg.d_in
    for _ in range(cfg.n_layers):
        d_out = cfg.d_hidden
        layers.append({
            "w_self": L.init_linear(rng, (d_in, d_out)),
            "w_neigh": L.init_linear(rng, (d_in, d_out)),
            "b": np.zeros((d_out,), np.float32),
        })
        d_in = d_out
    params = {
        "layers": layers,
        "head": L.init_linear(rng, (cfg.d_hidden, cfg.n_classes)),
        "graph_head": L.init_linear(rng, (cfg.d_hidden, 1)),
    }
    if abstract:
        return params
    return L.to_device(params, resolve_device(device), cfg.torch_dtype)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, ids, n_rows):
        ctx.save_for_backward(ids)
        return L.scatter_rows(rows, ids, n_rows)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return grad.index_select(0, ids), None, None


def segment_sum(rows: torch.Tensor, ids: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """``jax.ops.segment_sum(rows, ids, n_rows)`` in a fixed order
    (``layers.scatter_rows``); its backward gathers the gradient rows."""
    ids = ids.long()
    if torch.is_grad_enabled() and rows.requires_grad:
        return _SegmentSum.apply(rows, ids, n_rows)
    return L.scatter_rows(rows, ids, n_rows)


def _in_degree(ids: torch.Tensor, n: int, dtype) -> torch.Tensor:
    # integer-valued float sums below 2^24 are exact in any order
    return torch.zeros(n, dtype=dtype, device=ids.device).index_add_(
        0, ids.long(), torch.ones(ids.shape[0], dtype=dtype,
                                  device=ids.device))


def _mean_agg(h_src: torch.Tensor, dst: torch.Tensor,
              n_dst: int) -> torch.Tensor:
    """segment-mean of gathered source features into destination nodes."""
    s = segment_sum(h_src, dst, n_dst)
    deg = _in_degree(dst, n_dst, h_src.dtype)
    return s / torch.clamp(deg, min=1.0)[:, None]


def _sage_layer(lp: dict, h_self: torch.Tensor,
                agg: torch.Tensor) -> torch.Tensor:
    out = h_self @ lp["w_self"] + agg @ lp["w_neigh"] + lp["b"]
    out = torch.relu(out)
    # L2 normalize, as in the paper
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return out / torch.clamp(norm, min=1e-6)


def sage_forward_full(params: dict, cfg: SageConfig, x: torch.Tensor,
                      edges: torch.Tensor) -> torch.Tensor:
    """Full-batch forward.  x: (N, d_in); edges: (2, E) [src, dst].

    Returns (N, n_classes) float32 logits."""
    n = x.shape[0]
    h = x.to(cfg.torch_dtype)
    src, dst = edges[0], edges[1]
    for lp in params["layers"]:
        agg = _mean_agg(L.gather_rows(h, src), dst, n)
        h = _sage_layer(lp, h, agg)
    return (h @ params["head"]).to(torch.float32)


def sage_forward_blocks(params: dict, cfg: SageConfig,
                        feats: list[torch.Tensor],
                        blocks: list[dict]) -> torch.Tensor:
    """Sampled-minibatch forward over layered blocks (innermost first).

    feats[i]: features of the layer-i node frontier; blocks[i] has
    ``src_index`` (Ei,) indices into frontier i+1's nodes, ``dst_index``
    (Ei,) indices into frontier i's nodes, and ``n_dst``.  Frontier 0 is
    the seed batch.  Returns (n_seeds, n_classes) float32 logits."""
    hs = [f.to(cfg.torch_dtype) for f in feats]
    for lp in params["layers"]:
        new_hs = []
        # after layer li we only need frontiers 0..n_layers-li-1
        for depth in range(len(hs) - 1):
            blk = blocks[depth]
            h_src = L.gather_rows(hs[depth + 1], blk["src_index"])
            agg = _mean_agg(h_src, blk["dst_index"], hs[depth].shape[0])
            new_hs.append(_sage_layer(lp, hs[depth], agg))
        hs = new_hs
    return (hs[0] @ params["head"]).to(torch.float32)


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          mask: torch.Tensor | None = None) -> torch.Tensor:
    ll = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(ll, 1, labels.long()[:, None])[:, 0]
    if mask is None:
        return torch.mean(nll)
    m = mask.to(torch.float32)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def sage_loss_full(params, cfg: SageConfig, x, edges, labels, mask):
    return _xent(sage_forward_full(params, cfg, x, edges), labels, mask)


def sage_loss_blocks(params, cfg: SageConfig, feats, blocks, labels):
    return _xent(sage_forward_blocks(params, cfg, feats, blocks), labels)


def sage_graph_regression(params: dict, cfg: SageConfig, x: torch.Tensor,
                          edges: torch.Tensor, graph_id: torch.Tensor,
                          n_graphs: int) -> torch.Tensor:
    """Batched small graphs (molecule cell): mean-pool node embeddings per
    graph -> scalar prediction.  x: (B*n, d); edges over the disjoint
    union; graph_id: (B*n,) -> (B,)."""
    n = x.shape[0]
    h = x.to(cfg.torch_dtype)
    src, dst = edges[0], edges[1]
    for lp in params["layers"]:
        agg = _mean_agg(L.gather_rows(h, src), dst, n)
        h = _sage_layer(lp, h, agg)
    pooled = segment_sum(h, graph_id, n_graphs)
    cnt = _in_degree(graph_id, n_graphs, h.dtype)
    pooled = pooled / torch.clamp(cnt, min=1.0)[:, None]
    return (pooled @ params["graph_head"])[:, 0].to(torch.float32)


def sage_loss_molecule(params, cfg: SageConfig, x, edges, graph_id, y,
                       n_graphs: int):
    pred = sage_graph_regression(params, cfg, x, edges, graph_id, n_graphs)
    return torch.mean((pred - y) ** 2)
