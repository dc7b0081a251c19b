"""Shapes and model FLOPs of the LM family, copied from the JAX package's
``configs/lm_common.py`` (its dry-run bundles wait for ROADMAP item 7d).

Four shapes per arch:
  train_4k     seq 4096  x global_batch 256   -> train step
  prefill_32k  seq 32768 x batch 32           -> prefill (logits + KV cache)
  decode_32k   1 new token, 32k cache, batch 128 -> decode step
  long_500k    1 new token, 512k context, batch 1 -> decode step (SWA only)
"""

from __future__ import annotations

__all__ = ["LM_SHAPES", "model_flops"]

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
