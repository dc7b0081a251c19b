"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch,
a copy of the JAX package's ``models/moe.py`` (its ``"gspmd"`` path, run
on one device).

Tokens are ranked within their assigned expert by a stable sort (no
data-dependent shapes), scattered into a static (E, C, D) expert buffer,
transformed by a batched per-expert SwiGLU, and gathered back with their
gate weights; a token past its expert's capacity is dropped.  Router
softmax then top-k with renormalised gates, shared experts (deepseek)
and the Switch load-balancing aux loss are kept.  ``jax.lax.top_k``
takes the lower expert id on ties, and so does the first k of a stable
descending ``torch.sort`` (``torch.topk``'s tie order is unspecified).

``moe_ffn_shard_map`` (explicit all-to-all dispatch over a mesh) waits
for the distributed part of ROADMAP item 7.  With no mesh the reference
runs the local path whatever ``dispatch`` says, and so does the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

__all__ = ["MoEConfig", "moe_ffn", "init_moe_params"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # deepseek shared experts (dense, always-on)
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # deepseek: first 3 layers are dense FFN
    aux_loss_weight: float = 0.01
    #: "gspmd" or "shard_map" in the reference; one device runs the
    #: local dispatch for both
    dispatch: str = "gspmd"


def init_moe_params(rng, cfg: MoEConfig, d_model: int, n_layers: int,
                    dtype: torch.dtype, device=None) -> dict:
    """The (n_layers, ...) stacked expert tree on ``device``, drawn in
    the reference's order (router, w_gate, w_up, w_down, then the shared
    experts) by ``layers.draw_linear``; the router stays float32."""
    e, f = cfg.n_experts, cfg.d_ff_expert

    def lin(shape, dt=dtype):
        return L.draw_linear(rng, shape, dt, device)

    p = {
        "router": lin((n_layers, d_model, e), torch.float32),
        "w_gate": lin((n_layers, e, d_model, f)),
        "w_up": lin((n_layers, e, d_model, f)),
        "w_down": lin((n_layers, e, f, d_model)),
    }
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["shared_gate"] = lin((n_layers, d_model, fs))
        p["shared_up"] = lin((n_layers, d_model, fs))
        p["shared_down"] = lin((n_layers, fs, d_model))
    return p


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(np.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """x: (T, D) -> (y: (T, D), aux_loss: float32 scalar)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(t, cfg)
    dev = x.device

    logits = x.to(torch.float32) @ params["router"]           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = srt.values[:, :k], srt.indices[:, :k]       # (T, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # Switch aux loss: E * sum_e f_e * p_e, f_e from the routed counts
    me = probs.mean(dim=0)
    counts = torch.zeros((e,), dtype=torch.float32, device=dev).index_add_(
        0, eidx.reshape(-1), torch.ones((t * k,), dtype=torch.float32,
                                        device=dev))
    aux = cfg.aux_loss_weight * e * torch.sum(me * (counts / t))

    # rank of each (token, slot) within its expert, via a stable sort
    flat_e = eidx.reshape(-1)                                 # (T*K,)
    sidx = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[sidx]
    start = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    rank_sorted = torch.arange(t * k, device=dev) - start[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[sidx] = rank_sorted
    keep = rank < cap
    safe_rank = torch.where(keep, rank, 0)

    # dispatch into the (E, C, D) buffer.  The kept (expert, rank) pairs
    # are unique, and a dropped token adds an exact zero to its expert's
    # slot 0, so the accumulating scatter gives the reference's values in
    # any order of its adds.
    # each token repeated for its k slots; the backward of an expand is
    # a sum over the slots, in a fixed order (``repeat_interleave``'s
    # is an atomic ``index_add_`` on the card)
    x_rep = x[:, None].expand(t, k, d).reshape(t * k, d)      # (T*K, D)
    x_rep = torch.where(keep[:, None], x_rep, torch.zeros((), dtype=x.dtype,
                                                          device=dev))
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=dev)
    buf.index_put_((flat_e, safe_rank), x_rep, accumulate=True)

    # batched per-expert SwiGLU
    h = F.silu(torch.bmm(buf, params["w_gate"])) \
        * torch.bmm(buf, params["w_up"])
    y_buf = torch.bmm(h, params["w_down"])

    # combine
    y_tok = y_buf[flat_e, safe_rank]                          # (T*K, D)
    y_tok = y_tok * (gates.reshape(-1, 1) * keep[:, None]).to(y_tok.dtype)
    y = y_tok.reshape(t, k, d).sum(dim=1)

    if cfg.n_shared:
        y = y + L.swiglu(params["shared_gate"], params["shared_up"],
                         params["shared_down"], x)
    return y, aux
