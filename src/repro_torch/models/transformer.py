"""Decoder-only transformer LM: the JAX package's
``models/transformer.py`` (``init_params``, ``train_loss``, ``prefill``,
``decode_step`` over ``init_cache``).

One configurable implementation covering:

  * GQA attention with optional QKV bias (qwen2) and qk-norm (qwen3),
  * head_dim decoupled from d_model (qwen3: 128 * 32 heads != 2560),
  * sliding-window attention (mixtral) with ring-buffer decode caches,
  * MLA (deepseek's multi-head latent attention): a compressed cache of
    the latent ``c_kv`` and the *rotated* rope key, and the
    absorbed-matmul decode in the latent (``_decode_attn_mla``),
  * dense SwiGLU or MoE FFN (``models/moe.py``),
  * multi-token prediction (deepseek MTP) as an extra loss head of
    ``train_loss``: one block over (h_t, embed(token_{t+1})) @ proj
    predicting t+2.

Parameters are the reference's tree: ``embed``, ``final_norm``,
``lm_head`` and per group (``dense``, ``moe``) ``ln1``, ``ln2``,
``attn`` and ``ffn``, each leaf stacked over the group's layers as an
(L, ...) tensor.  ``init_params`` draws them from
``np.random.default_rng(seed)`` in the reference's order, equal to the
JAX draw bit for bit in float32 and bfloat16; a stacked weight keeps the
reference's ``fan_in = prod(shape[:-1])`` scale, (L * d) ** -0.5.

Layers run as a Python loop over the stacked tensors, where the
reference scans.  Prefill and training attention is
``attention.chunked_attention`` (the flash-attention kernel on a CUDA
tensor, once a layer; ``use_kernel=False`` runs its plain version; MLA's
value head dim takes its plain torch path), decode attention
``attention.decode_attention`` in torch ops.  The serving entry points
run under ``torch.inference_mode()``.  ``train_loss`` runs under
autograd: with ``remat == "full"`` each layer body is checkpointed
(``torch.utils.checkpoint``), as the reference's ``_scan_layers`` does,
so backward recomputes it (flash's forward launches again); the loss is
``layers.chunked_softmax_xent``.  The token embedding is read through
``layers.gather_rows``, whose backward adds duplicate tokens
in a fixed order (a bit-exact restart on the card needs that).
``decode_step`` writes the new key and value into the cache in place
and returns that cache: a
functional copy of the whole cache on every step would not fit beside
it on the card at the decode_32k shape (the reference's decode bundle
donates the cache for the same reason).

The reference's sharding hints (``distrib.hints``) are applied where
it applies them, and on one device or a plain tensor each is a no-op.
``backbone`` pins the embedding to ``lm_activations`` (batch over the
data axes, sequence over ``model``), and, since the layers are a Python
loop where the reference's scan carry keeps the layout, pins the
residual stream again at every layer boundary; a pinned layer keeps it
there as GSPMD does (``_layer_body``), with every product on each
device's blocks (``layers.linear``), so that DTensor's propagation picks
no layout inside it.  ``attn_q`` places the attention's queries
(``ops._layout``) and ``moe_buffer`` the MoE's expert buffer
(``moe._moe_gspmd_sharded``).  ``block_q`` is the
query block of flash's backward and of the plain MLA path,
``loss_block`` the loss's row block, ``remat`` steers training only;
``unroll`` (the reference's dry-run) is ignored, and so is ``remat ==
"ffn"`` (no config of either package sets it).

A quirk of the reference, kept: ``prefill`` leaves the last ``clen =
min(S, window)`` keys in slots ``0 .. clen-1``, while ``decode_step``
reads slot i as the position ``_slot_positions`` gives it (``p % clen``).
The two agree when S <= window or S % window == 0.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import is_dtensor, resolve_device
from repro_torch.distrib import hints as H
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.tree import leaves

__all__ = ["MLAConfig", "LMConfig", "init_params", "train_loss", "prefill",
           "decode_step", "init_cache", "cache_len", "backbone"]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's LM config, field for field.  Serving ignores
    ``remat`` and ``loss_block``; nothing reads ``unroll``."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    attn_type: str = "gqa"            # "gqa" | "mla"
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None      # sliding-window attention width
    rope_theta: float = 10_000.0
    moe: Optional[M.MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mtp: bool = False                 # deepseek multi-token prediction
    mtp_weight: float = 0.3
    dtype: str = "bfloat16"
    remat: str = "full"               # "none" | "full"
    block_q: int = 512
    loss_block: int = 512
    unroll: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return L.torch_dtype(self.dtype)

    @property
    def qk_dim(self) -> int:
        if self.attn_type == "mla":
            return self.mla.qk_nope_dim + self.mla.qk_rope_dim
        return self.head_dim

    def param_count(self) -> int:
        """Exact parameter count, from an abstract init that draws
        nothing (MLA and MTP trees included)."""
        tree = init_params(self, abstract=True)
        return sum(math.prod(leaf.shape) for leaf in leaves(tree))

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        total = self.param_count()
        if self.moe is None:
            return total
        e, k = self.moe.n_experts, self.moe.top_k
        n_moe_layers = self.n_layers - self.moe.first_dense_layers
        per_expert = 3 * self.d_model * self.moe.d_ff_expert
        inactive = n_moe_layers * per_expert * (e - k)
        return total - inactive


# ---------------------------------------------------------------- params --

def _norm(shape, dt, dev):
    """``init_norm``'s ones (an abstract init makes a FakeArray)."""
    if dev is None:
        return L.FakeArray(shape, dt)
    return torch.ones(shape, dtype=dt, device=dev)


def _zeros(shape, dt, dev):
    if dev is None:
        return L.FakeArray(shape, dt)
    return torch.zeros(shape, dtype=dt, device=dev)


def _attn_params(rng, cfg: LMConfig, n: int, dt, dev) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lin = L.draw_linear
    if cfg.attn_type == "mla":
        m = cfg.mla
        return {
            "wdq": lin(rng, (n, d, m.q_lora_rank), dt, dev),
            "q_norm": _norm((n, m.q_lora_rank), dt, dev),
            "wuq": lin(rng, (n, m.q_lora_rank,
                             hq * (m.qk_nope_dim + m.qk_rope_dim)), dt, dev),
            "wdkv": lin(rng, (n, d, m.kv_lora_rank + m.qk_rope_dim), dt,
                        dev),
            "kv_norm": _norm((n, m.kv_lora_rank), dt, dev),
            "wuk": lin(rng, (n, m.kv_lora_rank, hq * m.qk_nope_dim), dt,
                       dev),
            "wuv": lin(rng, (n, m.kv_lora_rank, hq * m.v_dim), dt, dev),
            "wo": lin(rng, (n, hq * m.v_dim, d), dt, dev),
        }
    p = {
        "wq": lin(rng, (n, d, hq * hd), dt, dev),
        "wk": lin(rng, (n, d, hkv * hd), dt, dev),
        "wv": lin(rng, (n, d, hkv * hd), dt, dev),
        "wo": lin(rng, (n, hq * hd, d), dt, dev),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros((n, hq * hd), dt, dev)
        p["bk"] = _zeros((n, hkv * hd), dt, dev)
        p["bv"] = _zeros((n, hkv * hd), dt, dev)
    if cfg.qk_norm:
        p["qn"] = _norm((n, hd), dt, dev)
        p["kn"] = _norm((n, hd), dt, dev)
    return p


def _dense_ffn_params(rng, cfg: LMConfig, n: int, dt, dev) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": L.draw_linear(rng, (n, d, f), dt, dev),
        "w_up": L.draw_linear(rng, (n, d, f), dt, dev),
        "w_down": L.draw_linear(rng, (n, f, d), dt, dev),
    }


def init_params(cfg: LMConfig, seed: int = 0, *, device=None,
                abstract: bool = False) -> dict:
    """Seeded parameters on ``device`` (default ``"cuda"``), equal to the
    JAX package's ``init_params`` for the same seed.  With ``abstract``
    every leaf is a ``layers.FakeArray`` and nothing is drawn or placed
    (no device is needed): what ``param_count`` counts."""
    dev = None if abstract else resolve_device(device)
    rng = L.rng_or_abstract(seed, abstract)
    dt = cfg.torch_dtype
    n_dense = cfg.moe.first_dense_layers if cfg.moe else cfg.n_layers
    n_moe = cfg.n_layers - n_dense
    params = {
        "embed": L.draw_linear(rng, (cfg.vocab, cfg.d_model), dt, dev,
                               scale=0.02),
        "final_norm": _norm((cfg.d_model,), dt, dev),
        "lm_head": L.draw_linear(rng, (cfg.d_model, cfg.vocab), dt, dev),
    }
    if n_dense:
        params["dense"] = {
            "ln1": _norm((n_dense, cfg.d_model), dt, dev),
            "ln2": _norm((n_dense, cfg.d_model), dt, dev),
            "attn": _attn_params(rng, cfg, n_dense, dt, dev),
            "ffn": _dense_ffn_params(rng, cfg, n_dense, dt, dev),
        }
    if n_moe:
        params["moe"] = {
            "ln1": _norm((n_moe, cfg.d_model), dt, dev),
            "ln2": _norm((n_moe, cfg.d_model), dt, dev),
            "attn": _attn_params(rng, cfg, n_moe, dt, dev),
            "ffn": M.init_moe_params(rng, cfg.moe, cfg.d_model, n_moe, dt,
                                     dev),
        }
    if cfg.mtp:
        params["mtp"] = {
            "ln1": _norm((1, cfg.d_model), dt, dev),
            "ln2": _norm((1, cfg.d_model), dt, dev),
            "attn": _attn_params(rng, cfg, 1, dt, dev),
            "ffn": _dense_ffn_params(rng, cfg, 1, dt, dev),
            "proj": L.draw_linear(rng, (1, 2 * cfg.d_model, cfg.d_model),
                                  dt, dev),
        }
    return params


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters (or cache): views of the stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _n_layers(stacked: dict) -> int:
    return leaves(stacked)[0].shape[0]


# --------------------------------------------------------------- forward --

def _project_qkv(lp: dict, cfg: LMConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """q/k/v of x (B, S, D) at ``positions`` (B, S), and MLA's latent
    (``c_kv`` (B, S, kv_lora_rank), the rotated rope key (B, S,
    qk_rope_dim)) or None."""
    b, s, _ = x.shape
    if cfg.attn_type == "mla":
        m = cfg.mla
        h = cfg.n_heads
        cq = L.rms_norm(lp["q_norm"], L.linear(x, lp["wdq"]))
        q = L.linear(cq, lp["wuq"]).reshape(b, s, h,
                                            m.qk_nope_dim + m.qk_rope_dim)
        q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
        q_rope = L.rope(q_rope, positions, cfg.rope_theta)
        dkv = L.linear(x, lp["wdkv"])
        c_kv = L.rms_norm(lp["kv_norm"], dkv[..., :m.kv_lora_rank])
        k_rope = L.rope(dkv[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)                      # (B, S, 1, rope)
        k_nope = L.linear(c_kv, lp["wuk"]).reshape(b, s, h, m.qk_nope_dim)
        v = L.linear(c_kv, lp["wuv"]).reshape(b, s, h, m.v_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_dim)],
                      dim=-1)
        return q, k, v, (c_kv, k_rope[:, :, 0])
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (L.linear(x, lp[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(lp["qn"], q)
        k = L.rms_norm(lp["kn"], k)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v, None


def _ffn(lp: dict, hn: torch.Tensor, moe_cfg):
    """The layer's FFN of hn (B, S, D), and its MoE aux loss (None for
    a dense layer)."""
    f = lp["ffn"]
    if moe_cfg is None:
        return L.swiglu(f["w_gate"], f["w_up"], f["w_down"], hn), None
    y, aux = M.moe_ffn(f, hn.reshape(-1, hn.shape[-1]), moe_cfg)
    return y.reshape(hn.shape), aux


def _seq_whole(x: torch.Tensor, pinned: bool) -> torch.Tensor:
    """x (B, S, D) of the pinned residual stream with its sequence
    gathered (an all-gather over each mesh dim that splits it): the
    FFN's entry.  Anything else as it is."""
    if not (pinned and is_dtensor(x)):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if p == Shard(1) else p for p in x.placements]
    return x.redistribute(x.device_mesh, pl)


def _layer_body(cfg: LMConfig, moe_cfg, use_kernel: bool, lp: dict,
                x: torch.Tensor, positions: torch.Tensor,
                pinned: bool = False):
    """One layer over x (B, S, D): (its output, its MoE aux loss or
    None, what the cache keeps: (k, v), or MLA's (c_kv, k_rope)).

    ``pinned``: x is the residual stream in the ``lm_activations``
    hint's layout (the sequence split over ``model``), and the layer
    keeps it there, as GSPMD keeps the reference's sequence
    parallelism.  The norms and the residual adds stay on the sequence
    shards.  Attention runs sequence-parallel, as the reference's
    projections are placed (replicated over ``model``): q, k and v are
    projected on each device's own rows (``layers.linear``), q stays
    there (the ``attn_q`` hint), and the attention gathers k and v.
    The FFN reads its input with the sequence gathered
    (``_seq_whole``), and its column- then row-parallel product's
    partial sum returns to the hint (a reduce-scatter).  On one device,
    or without the hint, every step is the plain one."""
    b, s, _ = x.shape
    q, k, v, lat = _project_qkv(lp["attn"], cfg, L.rms_norm(lp["ln1"], x),
                                positions)
    o = A.chunked_attention(q, k, v, causal=True, window=cfg.window,
                            block_q=cfg.block_q, use_kernel=use_kernel)
    o = L.linear(o.reshape(b, s, -1), lp["attn"]["wo"])
    h = x + (H.hint(o, "lm_activations") if pinned else o)
    y, aux = _ffn(lp, _seq_whole(L.rms_norm(lp["ln2"], h), pinned), moe_cfg)
    y = H.hint(y, "lm_activations") if pinned else y
    return h + y, aux, (lat if lat is not None else (k, v))


def _layer_train(cfg: LMConfig, moe_cfg, use_kernel: bool, pinned: bool,
                 lp: dict, x: torch.Tensor, positions: torch.Tensor):
    """``_layer_body`` for training: (output, aux as a 0-d float32)."""
    y, aux, _ = _layer_body(cfg, moe_cfg, use_kernel, lp, x, positions,
                            pinned)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return y, aux


def _cache_names(cfg: LMConfig) -> tuple[str, str]:
    return ("c_kv", "k_rope") if cfg.attn_type == "mla" else ("k", "v")


def _run_layers(cfg: LMConfig, stacked: dict, x: torch.Tensor,
                positions: torch.Tensor, moe_cfg, clen: int | None,
                use_kernel: bool, pinned: bool = False):
    """The group's layers over x (B, S, D): (x, the sum of the MoE aux
    losses, and with ``clen`` the last ``clen`` positions of each
    layer's cache entries stacked: {"k", "v"} (L, B, clen, Hkv, hd), or
    MLA's {"c_kv", "k_rope"} (L, B, clen, rank)).  Under autograd with
    ``remat == "full"`` each layer is checkpointed.  ``pinned``: the
    residual stream is pinned to the ``lm_activations`` hint at every
    layer boundary (the reference's scan carry keeps it there; a
    checkpointed layer's recompute pins its input the same way)."""
    s = x.shape[1]
    remat = (clen is None and cfg.remat == "full"
             and torch.is_grad_enabled())
    kept = ([], [])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(_n_layers(stacked)):
        lp = _layer(stacked, i)
        if pinned:
            x = H.hint(x, "lm_activations")
        if remat:
            x, a = checkpoint(_layer_train, cfg, moe_cfg, use_kernel, pinned,
                              lp, x, positions, use_reentrant=False)
        else:
            x, a, kv = _layer_body(cfg, moe_cfg, use_kernel, lp, x,
                                   positions, pinned)
            if clen is not None:
                for out, t in zip(kept, kv):
                    out.append(t[:, s - clen:])
        if a is not None:
            aux = aux + a
    cache = None if clen is None else {
        name: torch.stack(t) for name, t in zip(_cache_names(cfg), kept)}
    return x, aux, cache


def _groups(cfg: LMConfig):
    """(group name, its MoE config) in the reference's order: the groups
    that ``init_params`` makes, from the layer counts (static, so a
    captured decode step unrolls them whatever the tensors hold)."""
    n_dense = cfg.moe.first_dense_layers if cfg.moe else cfg.n_layers
    return [(g, cfg.moe if g == "moe" else None)
            for g, n in (("dense", n_dense), ("moe", cfg.n_layers - n_dense))
            if n]


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _embed(params: dict, cfg: LMConfig, tokens: torch.Tensor):
    return L.gather_rows(params["embed"], tokens).to(cfg.torch_dtype)


def backbone(params: dict, cfg: LMConfig, tokens: torch.Tensor,
             positions: torch.Tensor, *, use_kernel: bool = True):
    """tokens: (B, S) -> final hidden (B, S, D), aux loss (the sum of
    the MoE layers').  The embedding is pinned to the ``lm_activations``
    hint, and so is the residual stream at every layer boundary."""
    x = H.hint(_embed(params, cfg, tokens), "lm_activations")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g, moe_cfg in _groups(cfg):
        x, a, _ = _run_layers(cfg, params[g], x, positions, moe_cfg, None,
                              use_kernel, pinned=True)
        aux = aux + a
    return L.rms_norm(params["final_norm"], x), aux


def train_loss(params: dict, cfg: LMConfig, tokens: torch.Tensor,
               targets: torch.Tensor, mask: torch.Tensor, *,
               use_kernel: bool = True) -> torch.Tensor:
    """The mean masked next-token cross-entropy of tokens (B, S) against
    targets (B, S), plus ``mtp_weight`` times the MTP loss (deepseek:
    one dense block over (h_t, embed(token_{t+1})) @ proj, predicting
    t+2, the last position masked) and the MoE aux loss: a float32
    0-d tensor, differentiable in ``params``."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    h, aux = backbone(params, cfg, tokens, positions, use_kernel=use_kernel)
    loss = L.chunked_softmax_xent(h, params["lm_head"], targets,
                                  mask.to(torch.float32),
                                  block=cfg.loss_block)
    if cfg.mtp:
        mp = _layer(params["mtp"], 0)
        nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
        # the next tokens' embedding in the stream's layout (pinned), so
        # the MTP block continues the pinned stream
        e2 = H.hint(_embed(params, cfg, nxt), "lm_activations")
        hm = L.linear(torch.cat([h, e2], dim=-1), mp["proj"])
        hm, _, _ = _layer_body(cfg, None, use_kernel, mp, hm, positions,
                               pinned=True)
        t2 = torch.cat([targets[:, 1:], targets[:, -1:]], dim=1)
        m2 = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, -1:])], dim=1)
        mtp_loss = L.chunked_softmax_xent(hm, params["lm_head"], t2,
                                          m2.to(torch.float32),
                                          block=cfg.loss_block)
        loss = loss + cfg.mtp_weight * mtp_loss
    return loss + aux


def _serving(fn):
    """Run ``fn`` under ``torch.inference_mode()``, or under
    ``torch.no_grad()`` where the parameters are DTensors (the dry run's;
    inference mode does not take them)."""
    @functools.wraps(fn)
    def run(params, *args, **kwargs):
        mode = (torch.no_grad() if is_dtensor(params["embed"])
                else torch.inference_mode())
        with mode:
            return fn(params, *args, **kwargs)
    return run


@_serving
def prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor, *,
            use_kernel: bool = True):
    """Run the backbone over a prompt (B, S), build the KV cache, and
    return (logits of the last position (B, V) float32, cache): per
    group {"k", "v"} of (L, B, min(S, window), Hkv, hd), or MLA's
    {"c_kv", "k_rope"} of (L, B, S, rank)."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed(params, cfg, tokens)
    clen = cache_len(cfg, s)
    cache = {}
    for g, moe_cfg in _groups(cfg):
        x, _, cache[g] = _run_layers(cfg, params[g], x, positions,
                                     moe_cfg, clen, use_kernel)
    h = L.rms_norm(params["final_norm"], x)[:, -1]
    return (h @ params["lm_head"]).to(torch.float32), cache


# ---------------------------------------------------------------- decode --

def cache_len(cfg: LMConfig, seq_len: int) -> int:
    """SWA archs only need a window-sized ring buffer."""
    return min(seq_len, cfg.window) if cfg.window else seq_len


def init_cache(cfg: LMConfig, batch: int, seq_len: int, *,
               device=None) -> dict:
    """Zeroed caches on ``device`` (default ``"cuda"``) in the model
    dtype: per group {"k", "v"} of (L, batch, cache_len, Hkv, hd), or
    MLA's {"c_kv": (L, batch, cache_len, kv_lora_rank), "k_rope": (L,
    batch, cache_len, qk_rope_dim)}."""
    dev = resolve_device(device)
    s = cache_len(cfg, seq_len)
    if cfg.attn_type == "mla":
        m = cfg.mla
        per_layer = {"c_kv": (batch, s, m.kv_lora_rank),
                     "k_rope": (batch, s, m.qk_rope_dim)}
    else:
        kv = (batch, s, cfg.n_kv_heads, cfg.head_dim)
        per_layer = {"k": kv, "v": kv}
    n_dense = cfg.moe.first_dense_layers if cfg.moe else cfg.n_layers
    cache = {}
    for g, n in (("dense", n_dense), ("moe", cfg.n_layers - n_dense)):
        if n:
            cache[g] = {x: torch.zeros((n, *shape), dtype=cfg.torch_dtype,
                                       device=dev)
                        for x, shape in per_layer.items()}
    return cache


def _slot_positions(s: int, slot: torch.Tensor, pos: torch.Tensor):
    """Absolute position stored in each ring slot after the write at
    ``pos`` (slot i holds the largest position <= pos with pos' % s == i)."""
    i = torch.arange(s, device=pos.device)[None, :]
    p = pos[:, None]
    delta = (p % s - i) % s
    return p - delta


def _decode_attn_gqa(lp: dict, cfg: LMConfig, x: torch.Tensor, lc: dict,
                     pos: torch.Tensor) -> torch.Tensor:
    """x: (B, 1, D); lc's k/v: (B, S, Hkv, hd), written in place at slot
    pos % S; pos: (B,) the token's position."""
    b = x.shape[0]
    s = lc["k"].shape[1]
    q, k_new, v_new, _ = _project_qkv(lp, cfg, x, pos[:, None])
    slot = pos % s
    rows = torch.arange(b, device=pos.device)
    lc["k"][rows, slot] = k_new[:, 0]
    lc["v"][rows, slot] = v_new[:, 0]
    stored = _slot_positions(s, slot, pos)
    ages = pos[:, None] - stored
    valid = (stored >= 0) & (ages < (cfg.window or 10**9))
    o = A.decode_attention(q, lc["k"], lc["v"], valid)
    return o.reshape(b, 1, -1) @ lp["wo"]


def _decode_attn_mla(lp: dict, cfg: LMConfig, x: torch.Tensor, lc: dict,
                     pos: torch.Tensor) -> torch.Tensor:
    """Absorbed-matmul MLA decode: attention in the compressed latent.
    x: (B, 1, D); lc's c_kv (B, S, lora) and k_rope (B, S, rope) written
    in place at slot pos % S.  The reference's rounding points: scores
    in the cache dtype, float32 times the scale, the -1e30 mask, a
    float32 softmax, P cast to the cache dtype."""
    m = cfg.mla
    h = cfg.n_heads
    b = x.shape[0]
    s = lc["c_kv"].shape[1]
    cq = L.rms_norm(lp["q_norm"], x @ lp["wdq"])
    q = (cq @ lp["wuq"]).reshape(b, 1, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = L.rope(q_rope, pos[:, None], cfg.rope_theta)
    dkv = x @ lp["wdkv"]
    c_new = L.rms_norm(lp["kv_norm"], dkv[..., :m.kv_lora_rank])
    kr_new = L.rope(dkv[..., None, m.kv_lora_rank:], pos[:, None],
                    cfg.rope_theta)[:, :, 0]
    slot = pos % s
    rows = torch.arange(b, device=pos.device)
    c_kv, k_rope = lc["c_kv"], lc["k_rope"]
    c_kv[rows, slot] = c_new[:, 0]
    k_rope[rows, slot] = kr_new[:, 0]
    # absorb wuk into q: (B, 1, H, nope) x (lora, H * nope) -> (B, H, lora)
    wuk = lp["wuk"].reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    q_lat = torch.einsum("bqhn,lhn->bhl", q_nope, wuk)
    scores = (torch.einsum("bhl,bsl->bhs", q_lat, c_kv)
              + torch.einsum("bqhr,bsr->bhs", q_rope, k_rope))
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    stored = _slot_positions(s, slot, pos)
    valid = (stored >= 0) & (stored <= pos[:, None])
    scores = torch.where(valid[:, None, :], scores.to(torch.float32) * scale,
                         torch.full((), A.NEG_INF, device=x.device))
    p = torch.softmax(scores, dim=-1).to(c_kv.dtype)
    o_lat = torch.einsum("bhs,bsl->bhl", p, c_kv)
    wuv = lp["wuv"].reshape(m.kv_lora_rank, h, m.v_dim)
    o = torch.einsum("bhl,lhv->bhv", o_lat, wuv).reshape(b, 1, -1)
    return o @ lp["wo"]


def _decode_layers(cfg: LMConfig, stacked: dict, cache: dict, x, pos,
                   moe_cfg):
    for i in range(_n_layers(stacked)):
        lp = _layer(stacked, i)
        hn, lc = L.rms_norm(lp["ln1"], x), _layer(cache, i)
        if cfg.attn_type == "mla":
            h = x + _decode_attn_mla(lp["attn"], cfg, hn, lc, pos)
        else:
            h = x + _decode_attn_gqa(lp["attn"], cfg, hn, lc, pos)
        x = h + _ffn(lp, L.rms_norm(lp["ln2"], h), moe_cfg)[0]
    return x


@_serving
def decode_step(params: dict, cfg: LMConfig, cache: dict,
                token: torch.Tensor, pos: torch.Tensor):
    """One decode step.  token: (B,) int; pos: (B,) positions.

    Returns (next_token (B,) int32, logits (B, V) float32, cache), the
    cache updated in place."""
    pos = pos.long()
    x = _embed(params, cfg, token)[:, None, :]
    for g, moe_cfg in _groups(cfg):
        x = _decode_layers(cfg, params[g], cache[g], x, pos, moe_cfg)
    h = L.rms_norm(params["final_norm"], x)[:, 0]
    logits = (h @ params["lm_head"]).to(torch.float32)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache
