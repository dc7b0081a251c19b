"""Shared model layers: norms, RoPE, MLPs and the numpy initialisers.

A copy of what the funnel and the LM need from the JAX package's
``models/layers.py``: ``layer_norm`` and ``rms_norm`` (eps 1e-6,
statistics in float32, cast to the input's dtype before the weight),
``rope``, ``dense``, ``swiglu``, ``init_linear`` and ``init_norm``, and
the abstract draw (``FakeArray``, ``AbstractRNG``, ``rng_or_abstract``)
that counts parameters without making them.  Initialisers return numpy
arrays drawn from a caller's ``np.random.Generator``; ``to_device`` turns
a parameter tree of them into tensors.  ``chunked_softmax_xent`` is the
LM's training loss: (block, V) float32 logits at a time, recomputed in
backward as the reference's ``jax.checkpoint(one)`` recomputes them
(on the dry run's DTensors it runs vocabulary-parallel on each
device's rows, ``_sharded_xent``).

``gather_rows`` is the row gather of the token embedding and of every
recsys table (``jnp.take`` and table indexing in the JAX package), with
a deterministic backward (``scatter_rows``): the ids are sorted stably,
each run of one id summed in a fixed order by ``torch.segment_reduce``,
and the sums written to their distinct rows of a dense zero gradient.
A restarted training run must equal the clean run bit for bit, and the
library's backwards do not promise it: ``index_add_`` adds duplicates
with atomics, and ``index_put_`` with accumulate repeated its bits on
the card only by its implementation's sort, 30x slower at DIEN's
history shape (PERF.md, section 6).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import is_dtensor, is_fake

__all__ = ["layer_norm", "rms_norm", "rope", "dense", "linear", "swiglu",
           "init_linear", "init_norm", "draw_linear", "full_fp32_matmul",
           "check_full_fp32_matmul", "to_device", "torch_dtype",
           "chunked_softmax_xent", "gather_rows", "scatter_rows",
           "scatter_rows_static",
           "SCATTER_CHUNK",
           "FakeArray", "AbstractRNG", "rng_or_abstract", "abstract_leaves"]

#: model dtypes the port runs.  A bfloat16 parameter is drawn in float32
#: and rounded by torch, as ``ml_dtypes`` rounds the JAX package's draw
#: (through float32, to nearest even).
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} is not supported; use one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


class FakeArray:
    """Shape/dtype-only stand-in, so that a parameter count never draws
    or allocates the tree it counts."""

    def __init__(self, shape, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    def astype(self, dt):
        return FakeArray(self.shape, dt)


class AbstractRNG:
    """A ``np.random.Generator`` twin whose every draw is a FakeArray."""

    def normal(self, loc=0.0, scale=1.0, size=None):
        return FakeArray(size if size is not None else (), np.float32)


def rng_or_abstract(seed: int, abstract: bool):
    return AbstractRNG() if abstract else np.random.default_rng(seed)


def abstract_leaves(tree, dtype):
    """A tree of arrays and FakeArrays as FakeArrays of ``dtype`` (what
    ``to_device`` would cast it to), for an abstract init."""
    if isinstance(tree, dict):
        return {k: abstract_leaves(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [abstract_leaves(v, dtype) for v in tree]
    return FakeArray(tree.shape, dtype)


def rms_norm(w: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis: the statistic in float32, the
    normalised value cast to x's dtype, then times ``w`` in that dtype."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, hd); positions: (..., S).  The
    frequencies are float32 ``theta ** (-arange(half) / half)``; the
    rotation runs in float32 and is cast back to x's dtype."""
    half = x.shape[-1] // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    # theta as a scalar argument: a tensor of it made on the card would
    # be a pageable copy from the host, which waits for the stream
    freqs = torch.pow(theta, exps)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense(w: torch.Tensor, x: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w
    return y if b is None else y + b


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K) and w (K, N); on the dry run's DTensors,
    each device's product of its blocks (``_linear_sharded``)."""
    if is_dtensor(x):
        return _linear_sharded(x, w)
    return x @ w


def _linear_sharded(x, w):
    """``x @ w`` on DTensors, as a device computes it on its blocks, so
    that DTensor's propagation never chooses a layout for it (its
    choices for an FSDP weight against sharded rows move with the torch
    version).  Each mesh dim, by x's placement there:

    * x's rows split (evenly or strided, as a reshape leaves them): w
      whole there (its FSDP shard gathered), the output's rows split
      alike; w's gradient a partial sum;
    * x's K split: w split on its K (a row-parallel product), the output
      a partial sum;
    * x whole: w split on its N where it is placed so (a column-parallel
      product, the output's N split), else whole.

    A partial x is summed first, and a K split other than ``Shard``
    gathered.  The collectives are the weight's gathers, and in backward
    their reduce-scatters and the partial sums' reductions, all DTensor
    redistributions the dry run counts."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    last = x.ndim - 1

    def rows(p):            # a split of a leading dim (strided too)
        return getattr(p, "dim", None) not in (None, last)

    # x's K whole where it is summed or split other than evenly
    pl = [p if rows(p) or p == Shard(last) or p.is_replicate()
          else Replicate() for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(mesh, pl)
    w_pl, out_pl, w_grad, x_grad = [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if rows(px):
            w_pl.append(Replicate())
            out_pl.append(px)
            w_grad.append(Partial())
            x_grad.append(px)
        elif isinstance(px, Shard):                         # K
            w_pl.append(Shard(0))
            out_pl.append(Partial())
            w_grad.append(Shard(0))
            x_grad.append(px)
        elif pw == Shard(1):                                # N
            w_pl.append(pw)
            out_pl.append(Shard(last))
            w_grad.append(pw)
            x_grad.append(Partial())
        else:
            w_pl.append(Replicate())
            out_pl.append(Replicate())
            w_grad.append(Replicate())
            x_grad.append(Replicate())
    out = x.to_local(grad_placements=x_grad) @ w.redistribute(
        mesh, w_pl).to_local(grad_placements=w_grad)
    shape = (*x.shape[:-1], w.shape[-1])
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape, stride=stride)


def swiglu(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    return linear(F.silu(linear(x, w_gate)) * linear(x, w_up), w_down)


def layer_norm(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis, mean and variance in float32 (not
    ``nn.LayerNorm``, whose eps is 1e-5)."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * w + b


def _xent_block(hb, lm_head, tb, mb):
    """The summed masked cross-entropy of one block of rows."""
    logits = (hb @ lm_head).to(torch.float32)               # (block, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, tb[:, None])[:, 0]
    return torch.sum((lse - gold) * mb)


def _count_all_reduce(t: torch.Tensor, mesh, dims) -> None:
    """Issue (and drop) an all-reduce of ``t`` over mesh dims ``dims``:
    the sharded loss's exchanges of per-row statistics, which the dry
    run counts; on fake tensors their values carry nothing."""
    from torch.distributed._functional_collectives import all_reduce
    for d in dims:
        all_reduce(t.detach(), "sum", (mesh, d))


def _xent_block_local(hb, w, tb, mb, mesh, vocab_dims):
    """``_xent_block`` on one device's rows and vocabulary shard (the
    dry run's fake tensors): the row max, the row sum of exponentials
    and the target's logit are the vocabulary-parallel partial results,
    each all-reduced over the vocabulary's mesh dims."""
    logits = (hb @ w).to(torch.float32)                     # (block, V_l)
    m = logits.amax(dim=-1)
    s = torch.exp(logits - m[:, None]).sum(dim=-1)
    tl = tb.clamp(min=0, max=logits.shape[1] - 1)
    gold = torch.gather(logits, 1, tl[:, None])[:, 0]
    for t in (m, s, gold):
        _count_all_reduce(t, mesh, vocab_dims)
    return torch.sum((m + torch.log(s) - gold) * mb)


def _sharded_xent(hidden, lm_head, targets, mask, block):
    """``chunked_softmax_xent`` over DTensors (the dry run's): each device
    takes its own rows of ``hidden`` and a vocabulary-parallel shard of
    the ``lm_head`` (gathered over the data axes, as FSDP does), runs
    the blocks over its rows, and the per-device sums are a partial sum
    over the mesh."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = hidden.device_mesh
    vocab = [i for i, p in enumerate(lm_head.placements) if p == Shard(1)]
    w_pl = [Shard(1) if i in vocab else Replicate()
            for i in range(mesh.ndim)]
    w_grad = [Shard(1) if i in vocab else Partial()
              for i in range(mesh.ndim)]
    w = lm_head.redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
    # rows as the hidden state holds them, each row whole; a device's
    # rows flattened locally (the loss is a sum, in any order of rows),
    # so a (B, S) split of them needs no collective
    last = hidden.ndim - 1
    row_pl = [p if getattr(p, "dim", last) < last else Replicate()
              for p in hidden.placements]
    hl = hidden.redistribute(mesh, row_pl).to_local()
    hl = hl.reshape(-1, hl.shape[-1])
    rows = hl.shape[0]
    tl = targets.redistribute(mesh, row_pl).to_local().reshape(-1).long()
    ml = mask.redistribute(mesh, row_pl).to_local().reshape(-1)
    nblk = max(rows // block, 1)
    bl = rows // nblk
    grad = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hl.device)
    for i in range(nblk):
        sl = slice(i * bl, (i + 1) * bl)
        args = (hl[sl], w, tl[sl], ml[sl], mesh, vocab)
        total = total + (checkpoint(_xent_block_local, *args,
                                    use_reentrant=False)
                         if grad else _xent_block_local(*args))
    loss = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                              run_check=False, shape=(), stride=())
    return loss / torch.clamp(mask.sum(), min=1.0)


def chunked_softmax_xent(hidden: torch.Tensor, lm_head: torch.Tensor,
                         targets: torch.Tensor, mask: torch.Tensor,
                         block: int = 1024) -> torch.Tensor:
    """Cross-entropy without materialising (T, V) logits.

    hidden: (T, D), lm_head: (D, V), targets: (T,), mask: (T,) float32;
    or hidden (..., D) with targets and mask of its leading shape,
    flattened to T rows.  Runs over T in ``block`` rows, adding each
    block's sum in order, so the live logits are (block, V); under
    autograd each block is checkpointed, so its logits are recomputed
    in backward.  Returns the sum over T divided by max(sum(mask), 1)."""
    t = hidden.numel() // hidden.shape[-1]
    nblk = t // block
    if nblk * block != t:
        raise ValueError(f"T={t} not divisible by block={block}")
    if is_dtensor(hidden):
        return _sharded_xent(hidden, lm_head, targets, mask, block)
    hidden = hidden.reshape(t, hidden.shape[-1])
    targets = targets.reshape(t).long()
    mask = mask.reshape(t)
    grad = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nblk):
        sl = slice(i * block, (i + 1) * block)
        args = (hidden[sl], lm_head, targets[sl], mask[sl])
        total = total + (checkpoint(_xent_block, *args, use_reentrant=False)
                         if grad else _xent_block(*args))
    return total / torch.clamp(mask.sum(), min=1.0)


#: a run of one id is summed in chunks of this many rows, then the chunk
#: sums in order: one thread adds a run, and DIEN's padding reads row 0
#: some 2.4 M times a step at full width
SCATTER_CHUNK = 1024


def scatter_rows(rows: torch.Tensor, ids: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """The (n_rows, D) sum of ``rows`` (N, D) into rows ``ids`` (N,), in
    an order fixed by the ids alone: a stable sort, an in-order sum of
    each chunk of up to ``SCATTER_CHUNK`` rows of one id, an in-order sum
    of each id's chunk sums, and one write to each distinct row.

    On fake tensors (the dry run's memory estimate) the run lengths have
    no values: every chunk is taken for a distinct id (``nonzero`` and
    ``unique_consecutive`` at their largest outputs), so the buffers are
    allocated at their upper bounds; DTensors take
    ``scatter_rows_static``."""
    if is_dtensor(rows) or is_dtensor(ids):
        return scatter_rows_static(rows, ids, n_rows)
    out = rows.new_zeros((n_rows, rows.shape[1]))
    n = ids.numel()
    if n == 0:
        return out
    bound = is_fake(rows) or is_fake(ids)
    sorted_ids, order = torch.sort(ids, stable=True)
    pos = torch.arange(n, device=ids.device)
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    run_start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    chunk_start = first | ((pos - run_start) % SCATTER_CHUNK == 0)
    starts = (torch.nonzero(chunk_start) if not bound
              else pos.new_empty((n, 1))).flatten()
    lengths = torch.diff(starts, append=starts.new_full((1,), n))
    sums = torch.segment_reduce(rows[order], "sum", lengths=lengths, axis=0)
    if bound:
        uniq = sorted_ids[starts]
        counts = torch.empty_like(starts)
    else:
        uniq, counts = torch.unique_consecutive(sorted_ids[starts],
                                                return_counts=True)
    out[uniq] = torch.segment_reduce(sums, "sum", lengths=counts, axis=0)
    return out


def scatter_rows_static(rows: torch.Tensor, ids: torch.Tensor, n_rows: int,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """``scatter_rows``'s sum with static shapes: one ``index_add_`` into
    the (n_rows, D) zeros, the reference's ``segment_sum``.  The dry run
    traces it on DTensors, which have no strategy for ``scatter_rows``'
    sort, ``cummax`` and ``segment_reduce``; on real tensors it gives
    ``scatter_rows``' sums (in another order of the adds where a run is
    longer than ``SCATTER_CHUNK``)."""
    if out is None:
        out = rows.new_zeros((n_rows, rows.shape[1]))
    if is_dtensor(rows):
        # DTensor's in-place index_add_ re-places ``out`` without
        # resharding its local tensor; the out-of-place op is sound
        return torch.index_add(out, 0, ids, rows)
    return out.index_add_(0, ids, rows)


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




def init_linear(rng: np.random.Generator, shape, scale: float | None = None,
                dtype=np.float32) -> np.ndarray:
    fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[:-1]))
    s = scale if scale is not None else fan_in ** -0.5
    return rng.normal(0.0, s, shape).astype(dtype)


def init_norm(shape, dtype=np.float32) -> np.ndarray:
    return np.ones(shape, dtype)


#: float64 normals a slab of ``draw_linear`` holds on the host at most
_SLAB = 1 << 22


def draw_linear(rng, shape, dtype: torch.dtype, device,
                scale: float | None = None):
    """``init_linear``'s numbers as a ``dtype`` tensor on ``device``:
    float64 normals cast to float32, then rounded to ``dtype`` by torch
    (to nearest even, as ``ml_dtypes`` rounds the reference's draw),
    drawn a slab of rows at a time.  Consecutive ``Generator.normal``
    calls continue one stream, so the slabs give the one-call draw's
    values with a host peak of one slab.  An ``AbstractRNG`` gives a
    FakeArray and draws nothing."""
    fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[:-1]))
    s = scale if scale is not None else fan_in ** -0.5
    if isinstance(rng, AbstractRNG):
        return rng.normal(0.0, s, shape).astype(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.view(-1, shape[-1])
    step = max(1, _SLAB // shape[-1])
    for r0 in range(0, rows.shape[0], step):
        n = min(step, rows.shape[0] - r0)
        rows[r0:r0 + n] = torch.from_numpy(
            rng.normal(0.0, s, (n, shape[-1])).astype(np.float32))
    return out


def full_fp32_matmul() -> None:
    """Run float32 matrix products in full float32 on the card, as the
    reference does: TF32 off (``torch.backends.cuda.matmul.allow_tf32``
    and cuDNN's), precision "highest".  These are process-wide settings:
    a program sets them once, where it starts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def check_full_fp32_matmul(device: torch.device) -> None:
    """Raise if float32 matrix products on ``device`` would round through
    TF32 (see ``full_fp32_matmul``); a CPU device always passes."""
    if device.type != "cuda":
        return
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise ValueError(
            "float32 matrix products on the card would use TF32; call "
            "repro_torch.models.layers.full_fp32_matmul() first")


def to_device(tree, device, dtype: torch.dtype | None = None):
    """A nested dict/list of arrays as the same tree of tensors on
    ``device`` (cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device, dtype) for v in tree]
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(tree))
    return t.to(device=device, dtype=dtype)
