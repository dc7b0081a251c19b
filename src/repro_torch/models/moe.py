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

``moe_ffn_shard_map`` is the reference's explicit dispatch over a mesh
(``dispatch="shard_map"`` with the hints' ``"mesh"``): per position,
local routing and capacity dispatch (``_local_dispatch``), an all-to-all
sending each expert's rows to the position that holds it, the local
experts, the reverse all-to-all and the local combine (``_combine``).
One process drives every position, as ``distrib.collectives`` does: a
tensor is split into its per-position blocks, each moved to its
position's device, and the all-to-alls are copies between the lists.
Where the token count does not divide over the mesh (decode), or
without a mesh, the local path runs whatever ``dispatch`` says, as in
the reference.

On DTensors (the dry run's) ``moe_ffn`` takes the reference's branch,
on the reference's condition: the shard_map dispatch runs
``_moe_sharded``, each device's own program over its tokens and its
block of the experts, the layout the shard_map dispatch gives (experts
over the mesh dims that shard the expert weights' expert dim, the
expert width over the dims that shard it, tokens over the rest), with
the all-to-alls and the reduction of a split expert width issued as
collectives the dry run counts; every other call (the default
``"gspmd"`` dispatch, and shard_map's too few or indivisible tokens)
runs ``_moe_gspmd_sharded``, the single-program dispatch with its
(E, C, D) buffer placed by the ``moe_buffer`` hint.  So
``REPRO_MOE_SHARDMAP=1`` traces a program of its own.  Both return the
tokens to the caller's layout as a partial sum over the mesh dims the
dispatch split them over (``_tokens_back``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import is_dtensor
from repro_torch.distrib import collectives as C
from repro_torch.distrib import hints as H
from repro_torch.models import layers as L

__all__ = ["MoEConfig", "moe_ffn", "init_moe_params", "moe_ffn_shard_map"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # deepseek shared experts (dense, always-on)
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # deepseek: first 3 layers are dense FFN
    aux_loss_weight: float = 0.01
    #: "gspmd": the single-program dispatch; "shard_map": the explicit
    #: per-position dispatch over the hints' mesh (``moe_ffn_shard_map``)
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


def _top_k_gates(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig):
    """Router softmax then top-k with renormalised gates: (gates (T, K),
    expert ids (T, K), the router's probabilities (T, E))."""
    k = cfg.top_k
    logits = x.to(torch.float32) @ router                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = srt.values[:, :k], srt.indices[:, :k]       # (T, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, eidx, probs


def _expert_counts(eidx: torch.Tensor, e: int) -> torch.Tensor:
    """The (E,) float32 count of the (token, slot)s routed to each
    expert."""
    n = eidx.numel()
    return torch.zeros((e,), dtype=torch.float32,
                       device=eidx.device).index_add_(
        0, eidx.reshape(-1), torch.ones((n,), dtype=torch.float32,
                                        device=eidx.device))


def _route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig):
    """Router + top-k + Switch aux loss (shared by both dispatch paths):
    (gates (T, K), expert ids (T, K), aux)."""
    t = x.shape[0]
    e = cfg.n_experts
    gates, eidx, probs = _top_k_gates(router, x, cfg)
    # Switch aux loss: E * sum_e f_e * p_e, f_e from the routed counts
    me = probs.mean(dim=0)
    counts = _expert_counts(eidx, e)
    aux = cfg.aux_loss_weight * e * torch.sum(me * (counts / t))
    return gates, eidx, aux


def _expert_ranks(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """The rank of each (token, slot) of ``flat_e`` (T*K,) within its
    expert, in token order (a stable sort)."""
    dev = flat_e.device
    sidx = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[sidx]
    start = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    rank_sorted = torch.arange(flat_e.numel(), device=dev) - start[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[sidx] = rank_sorted
    return rank


def _scatter(x: torch.Tensor, flat_e, rank, e: int, cap: int, k: int):
    """Tokens x (T, D), each repeated for its k slots, into an (E, cap,
    D) buffer at (expert, rank): (buf, safe ranks, keep)."""
    t, d = x.shape
    dev = x.device
    keep = rank < cap
    safe_rank = torch.where(keep, rank, 0)
    # The kept (expert, rank) pairs are unique, and a dropped token adds
    # an exact zero to its expert's slot 0, so the accumulating scatter
    # gives the reference's values in any order of its adds.
    # each token repeated for its k slots; the backward of an expand is
    # a sum over the slots, in a fixed order (``repeat_interleave``'s
    # is an atomic ``index_add_`` on the card)
    x_rep = x[:, None].expand(t, k, d).reshape(t * k, d)      # (T*K, D)
    x_rep = torch.where(keep[:, None], x_rep, torch.zeros((), dtype=x.dtype,
                                                          device=dev))
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=dev)
    buf.index_put_((flat_e, safe_rank), x_rep, accumulate=True)
    return buf, safe_rank, keep


def _local_dispatch(x: torch.Tensor, eidx: torch.Tensor, e: int, cap: int):
    """Sort-based capacity dispatch of local tokens x (T, D): (buf (E,
    cap, D), flat expert ids, safe ranks, keep)."""
    # rank of each (token, slot) within its expert, via a stable sort
    flat_e = eidx.reshape(-1)                                 # (T*K,)
    rank = _expert_ranks(flat_e, e)
    buf, safe_rank, keep = _scatter(x, flat_e, rank, e, cap, eidx.shape[-1])
    return buf, flat_e, safe_rank, keep


def _experts(buf, w_gate, w_up, w_down):
    """Batched per-expert SwiGLU of buf (E, C, D)."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def _combine(y_buf, flat_e, safe_rank, keep, gates, t: int, k: int, d: int):
    y_tok = y_buf[flat_e, safe_rank]                          # (T*K, D)
    y_tok = y_tok * (gates.reshape(-1, 1) * keep[:, None]).to(y_tok.dtype)
    return y_tok.reshape(t, k, d).sum(dim=1)


def _shared(params: dict, x: torch.Tensor, y: torch.Tensor, cfg: MoEConfig):
    if cfg.n_shared:
        y = y + L.swiglu(params["shared_gate"], params["shared_up"],
                         params["shared_down"], x)
    return y


def _ep_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("model", "data") if a in mesh.axis_names)


def moe_ffn_shard_map(params: dict, x: torch.Tensor, cfg: MoEConfig, mesh):
    """The explicit-collective MoE over ``mesh`` (a ``DeviceMesh``).

    Tokens split over every position in mesh order; the experts over the
    expert-parallel axes (``model`` then ``data``, as the reference's
    ``P(("model", "data"))``), so member m of an expert group (its
    index over those axes, ``model`` major) holds experts [m E/n_ep,
    (m+1) E/n_ep).  Per position: local routing and dispatch into (E,
    cap, D), an all-to-all to (E/n_ep, n_ep cap, D) on each member, the
    resident experts, the reverse all-to-all, the local combine.  The
    aux loss is the mean over positions.  Returns (y (T, D), aux) on
    x's device; differentiable by autograd."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    names = mesh.axis_names
    ep = _ep_axes(mesh)
    n_ep = math.prod(mesh.shape[a] for a in ep)
    if e % n_ep:
        raise ValueError(f"{e} experts do not divide over {n_ep} positions")
    n_dev = mesh.devices.size
    t_loc = t // n_dev
    e_loc = e // n_ep
    cap = _capacity(t_loc, cfg)
    coords = list(np.ndindex(*mesh.devices.shape))
    member = {c: int(np.ravel_multi_index(
        [c[names.index(a)] for a in ep], [mesh.shape[a] for a in ep]))
        for c in coords}
    groups: dict[tuple, list] = {}
    for c in coords:
        key = tuple(c[i] for i, a in enumerate(names) if a not in ep)
        groups.setdefault(key, [None] * n_ep)[member[c]] = c
    dev = {c: mesh.devices[c] for c in coords}
    local = {}
    for i, c in enumerate(coords):
        xl = x[i * t_loc:(i + 1) * t_loc].to(dev[c])
        gates, eidx, aux = _route(params["router"].to(dev[c]), xl, cfg)
        buf, flat_e, rank, keep = _local_dispatch(xl, eidx, e, cap)
        local[c] = (buf, flat_e, rank, keep, gates, aux)
    back = {}
    for members in groups.values():
        # scatter expert rows to their owners: (E, cap, D) on each member
        # -> (E/n_ep, n_ep cap, D)
        got = C.all_to_all([local[m][0] for m in members], 0, 1)
        ys = []
        for j, (m, buf) in enumerate(zip(members, got)):
            blk = slice(j * e_loc, (j + 1) * e_loc)
            ys.append(_experts(buf, params["w_gate"][blk].to(dev[m]),
                               params["w_up"][blk].to(dev[m]),
                               params["w_down"][blk].to(dev[m])))
        # return the rows to their sources (the inverse all-to-all)
        back.update(zip(members, C.all_to_all(ys, 1, 0)))
    outs = []
    for c in coords:
        _, flat_e, rank, keep, gates, _ = local[c]
        outs.append(_combine(back[c], flat_e, rank, keep, gates, t_loc, k,
                             d).to(x.device))
    aux = C.pmean([local[c][5] for c in coords])[0].to(x.device)
    return _shared(params, x, torch.cat(outs, dim=0), cfg), aux


def _moe_sharded(params: dict, x, cfg: MoEConfig):
    """``moe_ffn`` on DTensors (the dry run's): one device's program
    (see the module docstring).  Expert-parallel mesh dims are those
    that shard the experts of ``w_gate`` (E, D, F), tensor-parallel ones
    those that shard its F; every other shard of the expert weights is
    gathered (FSDP).  Tokens are gathered over the tensor-parallel dims
    and split over every other dim, each token whole.  The all-to-alls and the reduction of a
    split F are issued as collectives on the local tensors (values
    carry nothing on fake tensors), the exchanged buffers are local
    reshapes of the same size."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    nd = mesh.ndim
    wg = params["w_gate"]
    ep = [i for i, p in enumerate(wg.placements) if p == Shard(0)]
    tp = [i for i, p in enumerate(wg.placements) if p == Shard(2)]

    def local_w(w, f_dim):
        pl = [Shard(0) if i in ep else Shard(f_dim) if i in tp
              else Replicate() for i in range(nd)]
        grad = [p if i in ep + tp else Partial() for i, p in enumerate(pl)]
        return w.redistribute(mesh, pl).to_local(grad_placements=grad)

    w_gate, w_up = local_w(wg, 2), local_w(params["w_up"], 2)
    w_down = local_w(params["w_down"], 1)
    router = params["router"]
    if is_dtensor(router):
        router = router.redistribute(
            mesh, [Replicate()] * nd).to_local(
            grad_placements=[Partial()] * nd)
    # each token whole; every token of a tensor-parallel group on each
    # of its devices; the tokens split over every other mesh dim (each
    # expert-parallel device routes tokens of its own, as the shard_map
    # dispatch's token spec over all axes)
    x_pl = [Replicate() if i in tp
            else Shard(0) if p.is_partial() or p == Shard(1) or p.is_replicate()
            else p for i, p in enumerate(x.placements)]
    x_grad = [Partial() if i in tp else p for i, p in enumerate(x_pl)]
    xg = x.redistribute(mesh, x_pl)
    xl = xg.to_local(grad_placements=x_grad)
    t, d = xl.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(t, cfg)
    gates, eidx, aux = _route(router, xl, cfg)
    buf, flat_e, rank, keep = _local_dispatch(xl, eidx, e, cap)
    n_ep = math.prod(mesh.size(i) for i in ep)
    e_loc = e // n_ep

    def exchange(t_, dims):
        for i in dims:
            funcol.all_to_all_single(t_.detach().reshape(-1), None, None,
                                     (mesh, i))

    if ep:
        exchange(buf, ep)
        buf = buf.reshape(n_ep, e_loc, cap, d).transpose(0, 1).reshape(
            e_loc, n_ep * cap, d)
    y = _experts(buf, w_gate, w_up, w_down)
    for i in tp:
        funcol.all_reduce(y.detach(), "sum", (mesh, i))
    if ep:
        exchange(y, ep)
        y = y.reshape(e_loc, n_ep, cap, d).transpose(0, 1).reshape(
            e, cap, d)
    out = _combine(y, flat_e, rank, keep, gates, t, k, d)
    # back to the tokens' own layout (the rows return to their sources)
    out = _tokens_back(out, x, x_pl, [
        i for i, p in enumerate(x_pl)
        if p == Shard(0) and x.placements[i] != Shard(0)])
    aux = DTensor.from_local(aux, mesh, [Partial("avg")] * nd,
                             run_check=False, shape=(), stride=())
    return _shared(params, x, out, cfg), aux


def _token_split(x):
    """The dry run's gspmd body: placements of x (T, D) that split its
    tokens over every mesh dim they divide over, each token whole, and
    the dims added to x's own token split.  x's own ``Shard(0)`` dims
    stay; a dim after the last of them is added where the tokens divide
    (so a device's tokens are a block of its rows of x); any other
    placement is gathered."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    own = [i for i, p in enumerate(x.placements) if p == Shard(0)]
    n = math.prod(mesh.size(i) for i in own)
    out, extra = [], []
    for i, p in enumerate(x.placements):
        if i in own:
            out.append(p)
        elif (i > max(own, default=-1)
              and x.shape[0] % (n * mesh.size(i)) == 0
              and x.shape[0] >= n * mesh.size(i)):
            out.append(Shard(0))
            extra.append(i)
            n *= mesh.size(i)
        else:
            out.append(Replicate())
    return out, extra


def _moe_gspmd_sharded(params: dict, x, cfg: MoEConfig):
    """``moe_ffn``'s ``"gspmd"`` body on DTensors (the dry run's): the
    reference's single-program dispatch, its buffer placed by the
    ``moe_buffer`` hint.

    Each device routes its own tokens (``_token_split``; tokens a mesh
    dim does not split are routed alike on each of its devices).  The
    capacity is the global one, ``_capacity(T)``.  Each (token, slot)'s
    rank within its expert comes from a stable sort of all T*K expert
    ids, gathered (as GSPMD gathers them).  Each device scatters its
    tokens into a whole (E, C, D) buffer, a partial sum over the dims
    that split the tokens, and the hint takes it to its own layout (a
    reduce-scatter; the reference's ``P(experts over model, capacity
    over data, None)``).  The batched SwiGLU runs on the buffer's block
    with the expert weights laid out to match (experts where the buffer
    splits them, the expert width split where the weights split it and
    the buffer does not: a partial sum the hint reduces), and its
    output takes the hint again.  The combine gathers the output buffer
    whole and fetches each token's rows; the tokens return to x's
    layout as a partial sum over the dims the split added, so the
    layer's return to its own hint is the reduce-scatter it makes of
    the shared experts' row-parallel product.  Without the hint the
    buffer is replicated (an all-reduce).  The aux loss takes the
    global routed counts and mean probabilities (all-reduces)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    nd = mesh.ndim
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(t, cfg)
    tok, extra = _token_split(x)
    split = [i for i, p in enumerate(tok) if p == Shard(0)]
    # a value each device holds a share of: summed over the token split
    sums = [Partial() if i in split else Replicate() for i in range(nd)]
    xl = x.redistribute(mesh, tok).to_local(grad_placements=tok)
    t_loc = xl.shape[0]
    router = params["router"]
    if is_dtensor(router):
        router = router.redistribute(mesh, [Replicate()] * nd).to_local(
            grad_placements=sums)
    gates, eidx, probs = _top_k_gates(router, xl, cfg)

    def summed(v):
        return DTensor.from_local(v, mesh, sums, run_check=False,
                                  shape=v.shape, stride=v.stride()
                                  ).redistribute(mesh, [Replicate()] * nd)

    me = summed(probs.sum(dim=0) / t)
    counts = summed(_expert_counts(eidx, e))
    aux = cfg.aux_loss_weight * e * torch.sum(me * (counts / t))
    # each (token, slot)'s rank within its expert, from all the ids
    flat_e = eidx.reshape(-1)                                 # (T_loc*K,)
    ids = DTensor.from_local(flat_e, mesh, tok, run_check=False,
                             shape=(t * k,), stride=(1,))
    rank = DTensor.from_local(
        _expert_ranks(ids.full_tensor(), e), mesh, [Replicate()] * nd,
        run_check=False).redistribute(mesh, tok).to_local()
    buf, safe_rank, keep = _scatter(xl, flat_e, rank, e, cap, k)
    buf = DTensor.from_local(buf, mesh, sums, run_check=False,
                             shape=buf.shape, stride=buf.stride())
    buf = H.hint(buf, "moe_buffer")
    if any(p.is_partial() for p in buf.placements):
        buf = buf.redistribute(mesh, [Replicate()] * nd)
    bp = list(buf.placements)
    wg = params["w_gate"]
    tp = [i for i, p in enumerate(wg.placements)
          if p == Shard(2) and bp[i] == Replicate()]

    def local_w(w, f_dim):
        pl = [Shard(0) if bp[i] == Shard(0) else Shard(f_dim) if i in tp
              else Replicate() for i in range(nd)]
        grad = [Partial() if bp[i] == Shard(1) else p
                for i, p in enumerate(pl)]
        return w.redistribute(mesh, pl).to_local(grad_placements=grad)

    y = _experts(buf.to_local(grad_placements=[
        Partial() if i in tp else p for i, p in enumerate(bp)]),
        local_w(wg, 2), local_w(params["w_up"], 2),
        local_w(params["w_down"], 1))
    y = DTensor.from_local(y, mesh, [Partial() if i in tp else p
                                     for i, p in enumerate(bp)],
                           run_check=False, shape=buf.shape,
                           stride=buf.stride())
    y = H.hint(y, "moe_buffer")
    # the combine: the output buffer whole, each token's rows fetched
    y = y.redistribute(mesh, [Replicate()] * nd).to_local(
        grad_placements=sums)
    out = _combine(y, flat_e, safe_rank, keep, gates, t_loc, k, d)
    return _shared(params, x, _tokens_back(out, x, tok, extra), cfg), aux


def _tokens_back(out, x, tok, extra):
    """The local rows ``out`` of tokens placed by ``tok`` as a DTensor
    of x's shape: on the dims ``_token_split`` added, a partial sum of
    x's block of rows with this device's rows in place (zeros
    elsewhere), so that no collective runs until the caller's layout
    asks for one; on the others, ``tok``'s placements."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = x.device_mesh
    pl = list(tok)
    own = [i for i, p in enumerate(x.placements) if p == Shard(0)]
    if extra and min(extra) < max(own, default=-1):
        raise ValueError(f"tokens split over {tok} are not blocks of the "
                         f"rows x holds under {x.placements}")
    if extra:
        n = math.prod(mesh.size(i) for i in extra)
        pos = 0
        for i in extra:
            pos = pos * mesh.size(i) + mesh.get_local_rank(i)
        t_loc = out.shape[0]
        out = F.pad(out, (0, 0, pos * t_loc, (n - 1 - pos) * t_loc))
        for i in extra:
            pl[i] = Partial()
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=x.shape, stride=(x.shape[1], 1))


def _shard_map_mesh(n_tokens: int, cfg: MoEConfig):
    """The hints' mesh where the reference runs its shard_map dispatch
    (``dispatch="shard_map"``, a global token count that divides over
    every device and is at least their count, the experts dividing over
    the expert-parallel axes), else None."""
    mesh = H.get("mesh") if cfg.dispatch == "shard_map" else None
    if mesh is None:
        return None
    n_dev = mesh.devices.size
    n_ep = math.prod(mesh.shape[a] for a in _ep_axes(mesh))
    if (n_tokens % n_dev == 0 and n_tokens >= n_dev
            and cfg.n_experts % n_ep == 0):
        return mesh
    return None     # too few tokens (decode) or indivisible: gspmd


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """x: (T, D) -> (y: (T, D), aux_loss: float32 scalar)."""
    mesh = _shard_map_mesh(x.shape[0], cfg)
    if is_dtensor(x):
        if mesh is not None:
            return _moe_sharded(params, x, cfg)
        return _moe_gspmd_sharded(params, x, cfg)
    if mesh is not None:
        return moe_ffn_shard_map(params, x, cfg, mesh)
    t, d = x.shape
    cap = _capacity(t, cfg)
    gates, eidx, aux = _route(params["router"], x, cfg)
    buf, flat_e, safe_rank, keep = _local_dispatch(x, eidx, cfg.n_experts,
                                                   cap)
    y_buf = _experts(buf, params["w_gate"], params["w_up"], params["w_down"])
    y = _combine(y_buf, flat_e, safe_rank, keep, gates, t, cfg.top_k, d)
    return _shared(params, x, y, cfg), aux
