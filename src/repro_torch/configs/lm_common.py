"""Shared dry-run bundles of the LM transformer family (the port of the
JAX package's ``configs/lm_common.py``).

Four shapes per arch:
  train_4k     seq 4096  x global_batch 256   -> train step (fwd+bwd+AdamW)
  prefill_32k  seq 32768 x batch 32           -> prefill (logits + KV cache)
  decode_32k   1 new token, 32k cache, batch 128 -> decode step
  long_500k    1 new token, 512k context, batch 1 -> decode step (SWA only)

Sharding: batch over the dp axes; Megatron TP + FSDP from
``distrib.sharding.lm_param_specs``; decode caches shard their sequence
dim over 'model' (the KV head counts do not divide 16 on these archs).

``bundle`` keeps the reference's two probe modes, so the argument trees
of both can be held against the reference's: ``"cost"`` is the config
the reference compiles unrolled at a reduced depth (layers 2 and 4
above the dense ones, extrapolated to the full depth), ``"mem"`` its
full-depth scan form (query block 512, loss block 4096).  The port's
dry run traces the ``"mem"`` bundle at full depth on fake tensors, one
trace a cell: a fake-tensor trace runs every layer, so it needs no
extrapolation.  ``REPRO_LM_REMAT``, ``REPRO_MOE_SHARDMAP`` and
``REPRO_MOMENT_DTYPE`` are read as the reference reads them.  The
bundle's hints are the reference's (``lm_activations``, ``attn_q``,
``moe_buffer`` and the ``mesh``), and the model code applies each where
the reference does (``models/transformer.py``, ``attention``'s
``ops._layout``, ``models/moe.py``).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.configs.base import (Bundle, abstract_tree, fake_mode,
                                      train_step_fn)
from repro_torch.distrib import sharding as S
from repro_torch.distrib.sharding import P

__all__ = ["LM_SHAPES", "bundle", "model_flops"]

LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, batch=1),
}


def model_flops(cfg, kind: str, batch: int, seq_len: int) -> float:
    """6·N_active·D (train) / 2·N_active·D (inference): the 'useful
    FLOPs' of a step (attention excluded by convention)."""
    n_act = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_act * batch * seq_len
    if kind == "prefill":
        return 2.0 * n_act * batch * seq_len
    return 2.0 * n_act * batch          # decode: one token per sequence


def _named(mesh, spec_tree):
    return S.tree_shardings(mesh, spec_tree)


def _cache_specs(cfg, cache, mesh) -> dict:
    """Shard the cache sequence dim over 'model', batch over dp (each
    only where it divides)."""
    dp = S.dp_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    tp = mesh.shape.get("model", 1)
    dp_n = S.MeshInfo(mesh).dp_size

    def rule(leaf):
        # (L, B, S, ...) layout from init_cache
        b, s = leaf.shape[1], leaf.shape[2]
        batch_ax = dp if (b % dp_n == 0 and b >= dp_n) else None
        seq_ax = "model" if s % tp == 0 and s >= tp else None
        return P(None, batch_ax, seq_ax, *([None] * (leaf.dim() - 3)))

    return {g: {k: rule(v) for k, v in c.items()} for g, c in cache.items()}


def bundle(cfg, shape_name: str, mesh, adam=None,
           mode: str = "cost") -> Bundle:
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    sh = LM_SHAPES[shape_name]
    kind, seq, batch = sh["kind"], sh["seq_len"], sh["batch"]
    orig_cfg = cfg
    probe_pair = None
    if mode == "cost":
        cfg = dataclasses.replace(
            cfg, unroll=True, block_q=2048 if kind == "prefill" else 1024,
            loss_block=min(65536, batch * seq))
        # the reference's two-point layer extrapolation: compiled at two
        # reduced depths (deepseek keeps its 3 dense layers in both)
        if cfg.n_layers > 8:
            base_dense = cfg.moe.first_dense_layers if cfg.moe else 0
            l1, l2 = base_dense + 2, base_dense + 4
            probe_pair = (l1, l2, orig_cfg.n_layers)
            cfg = dataclasses.replace(cfg, n_layers=l2)
    elif mode == "mem":
        cfg = dataclasses.replace(
            cfg, unroll=False, block_q=512,
            loss_block=min(4096, batch * seq))
    # mode == "raw": cfg as given (the reference's l1 probe)
    if os.environ.get("REPRO_LM_REMAT"):
        cfg = dataclasses.replace(cfg, remat=os.environ["REPRO_LM_REMAT"])
    if (os.environ.get("REPRO_MOE_SHARDMAP", "0") == "1"
            and cfg.moe is not None):
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch="shard_map"))
    adam = adam or adamw.AdamWConfig()
    dp = S.dp_axes(mesh)
    dp_ax = dp if len(dp) > 1 else dp[0]
    dp_n = S.MeshInfo(mesh).dp_size
    batch_ax = dp_ax if batch % dp_n == 0 and batch >= dp_n else None

    params_abs = abstract_tree(T.init_params(cfg, abstract=True))
    p_specs = S.lm_param_specs(params_abs, mesh)
    p_sh = _named(mesh, p_specs)
    # sequence parallelism: layer-boundary activations shard their seq
    # dim over 'model'
    tp = mesh.shape.get("model", 1)
    seq_ax = "model" if kind != "decode" and seq % tp == 0 else None
    act_hint = S.NamedSharding(mesh, P(batch_ax, seq_ax, None))
    # attention q (B, Hkv, G, S, hd): sequence-parallel over 'model'
    q_hint = S.NamedSharding(mesh, P(batch_ax, None, None, seq_ax, None))
    moe_hint = None
    if cfg.moe is not None:
        if (os.environ.get("REPRO_MOE_EP2D", "0") == "1"
                and cfg.moe.n_experts % (tp * dp_n) == 0):
            e_ax = ("model",) + S.dp_axes(mesh)
            moe_hint = S.NamedSharding(mesh, P(e_ax, None, None))
        else:
            e_ax = "model" if cfg.moe.n_experts % tp == 0 else None
            moe_hint = S.NamedSharding(mesh, P(e_ax, dp_ax, None))
    hints = {"lm_activations": act_hint, "mesh": mesh}
    if seq_ax is not None:
        hints["attn_q"] = q_hint
    if moe_hint is not None:
        hints["moe_buffer"] = moe_hint

    meta = dict(
        arch=orig_cfg.name, shape=shape_name, kind=kind, batch=batch,
        seq_len=seq, params=orig_cfg.param_count(),
        active_params=orig_cfg.active_param_count(),
        model_flops=model_flops(orig_cfg, kind, batch, seq),
    )
    if probe_pair is not None:
        l1, l2, full = probe_pair
        meta["cost_extrapolation"] = {"l1": l1, "l2": l2, "full": full}
        meta["l1_bundle"] = bundle(
            dataclasses.replace(cfg, n_layers=l1), shape_name, mesh, adam,
            mode="raw")

    if kind == "train":
        mdt = getattr(torch, os.environ.get("REPRO_MOMENT_DTYPE", "float32"))
        with fake_mode():
            opt_abs = adamw.init_opt_state(params_abs, moment_dtype=mdt)
            batch_abs = {k: torch.empty((batch, seq), dtype=torch.int32)
                         for k in ("tokens", "targets", "mask")}
        o_sh = _named(mesh, S.lm_opt_specs(p_specs, params_abs, mesh))
        b_sh = {k: S.NamedSharding(mesh, P(batch_ax, None))
                for k in batch_abs}
        return Bundle(fn=train_step_fn(lambda p, d: T.train_loss(
            p, cfg, d["tokens"], d["targets"], d["mask"]), adam),
                      args=(params_abs, opt_abs, batch_abs),
                      in_shardings=(p_sh, o_sh, b_sh),
                      out_shardings=(p_sh, o_sh, None),
                      donate_argnums=(0, 1), hints=hints, meta=meta)

    if kind == "prefill":
        with fake_mode():
            tokens_abs = torch.empty((batch, seq), dtype=torch.int32)

        def prefill_step(params, tokens):
            return T.prefill(params, cfg, tokens)

        return Bundle(fn=prefill_step, args=(params_abs, tokens_abs),
                      in_shardings=(p_sh,
                                    S.NamedSharding(mesh, P(batch_ax, None))),
                      out_shardings=None, donate_argnums=(), hints=hints,
                      meta=meta)

    # decode
    with fake_mode():
        cache_abs = T.init_cache(cfg, batch, seq, device="cpu")
        tok_abs = torch.empty((batch,), dtype=torch.int32)
        pos_abs = torch.empty((batch,), dtype=torch.int32)
    c_sh = _named(mesh, _cache_specs(cfg, cache_abs, mesh))
    v_sh = S.NamedSharding(mesh, P(batch_ax))

    def serve_step(params, cache, token, pos):
        return T.decode_step(params, cfg, cache, token, pos)

    return Bundle(fn=serve_step,
                  args=(params_abs, cache_abs, tok_abs, pos_abs),
                  in_shardings=(p_sh, c_sh, v_sh, v_sh),
                  out_shardings=(None, None, c_sh), donate_argnums=(1,),
                  hints=hints, meta=meta)
