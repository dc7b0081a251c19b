"""Synthetic click-log generators for the four recsys architectures: a
numpy copy of the JAX package's ``data/recsys_data.py``, bit-equal to it.

Labels are drawn from a planted logistic model over the sampled ids so the
models have real signal to fit (smoke tests assert loss decreases).
Deterministic in (seed, step, host) like the LM pipeline.
"""

from __future__ import annotations

import numpy as np

__all__ = ["wide_deep_batch", "dien_batch", "bst_batch", "mind_batch",
           "tower_batch"]


def _rng(seed, step, host=0):
    return np.random.default_rng((seed * 999_983 + step) * 64 + host)


def wide_deep_batch(cfg, batch: int, step: int, seed: int = 0,
                    host: int = 0) -> dict:
    r = _rng(seed, step, host)
    sparse = r.integers(0, cfg.vocab_per_field, (batch, cfg.n_sparse))
    cross = r.integers(0, cfg.cross_vocab, (batch, cfg.n_cross))
    dense = r.normal(size=(batch, cfg.n_dense)).astype(np.float32)
    z = (np.sin(sparse[:, 0] * 0.37) + 0.5 * dense[:, 0]
         + 0.3 * np.cos(cross[:, 0] * 0.11))
    label = (r.random(batch) < 1 / (1 + np.exp(-z))).astype(np.int32)
    return {"sparse_ids": sparse.astype(np.int32),
            "cross_ids": cross.astype(np.int32),
            "dense": dense, "label": label}


def dien_batch(cfg, batch: int, step: int, seed: int = 0, host: int = 0) -> dict:
    r = _rng(seed, step, host)
    t = cfg.seq_len
    hist = r.integers(0, cfg.item_vocab, (batch, t))
    lens = r.integers(t // 4, t + 1, batch)
    hist[np.arange(t)[None, :] >= lens[:, None]] = -1
    cats = np.where(hist >= 0, hist % cfg.cat_vocab, 0)
    target = r.integers(0, cfg.item_vocab, batch)
    prof = r.normal(size=(batch, cfg.n_profile)).astype(np.float32)
    z = np.sin(target * 0.21) + 0.3 * prof[:, 0]
    label = (r.random(batch) < 1 / (1 + np.exp(-z))).astype(np.int32)
    return {"hist_items": hist.astype(np.int32),
            "hist_cats": cats.astype(np.int32),
            "target_item": target.astype(np.int32),
            "target_cat": (target % cfg.cat_vocab).astype(np.int32),
            "profile": prof, "label": label}


def bst_batch(cfg, batch: int, step: int, seed: int = 0, host: int = 0) -> dict:
    r = _rng(seed, step, host)
    t = cfg.seq_len
    hist = r.integers(0, cfg.item_vocab, (batch, t))
    lens = r.integers(max(t // 4, 1), t + 1, batch)
    hist[np.arange(t)[None, :] >= lens[:, None]] = -1
    target = r.integers(0, cfg.item_vocab, batch)
    prof = r.normal(size=(batch, cfg.n_profile)).astype(np.float32)
    z = np.cos(target * 0.13) + 0.3 * prof[:, 1]
    label = (r.random(batch) < 1 / (1 + np.exp(-z))).astype(np.int32)
    return {"hist_items": hist.astype(np.int32),
            "target_item": target.astype(np.int32),
            "profile": prof, "label": label}


def mind_batch(cfg, batch: int, step: int, seed: int = 0, host: int = 0) -> dict:
    r = _rng(seed, step, host)
    t = cfg.seq_len
    # users have latent interests: items cluster by residue classes
    interest = r.integers(0, 8, batch)
    base = r.integers(0, cfg.item_vocab // 8, (batch, t))
    hist = (base * 8 + interest[:, None]) % cfg.item_vocab
    lens = r.integers(t // 3, t + 1, batch)
    hist[np.arange(t)[None, :] >= lens[:, None]] = -1
    target = ((r.integers(0, cfg.item_vocab // 8, batch) * 8 + interest)
              % cfg.item_vocab)
    return {"hist_items": hist.astype(np.int32),
            "target_item": target.astype(np.int32)}


def tower_batch(cfg, batch: int, step: int, seed: int = 0, host: int = 0) -> dict:
    r = _rng(seed, step, host)
    feats = r.normal(size=(batch, cfg.d_user_in)).astype(np.float32)
    # planted structure: the positive item is a (fixed) hash of the user's
    # preference direction, so the in-batch softmax has signal to fit
    w = np.random.default_rng(seed + 991).normal(
        size=(cfg.d_user_in, 2)).astype(np.float32)
    z = feats @ w
    cell = (np.floor(z * 1.5).astype(np.int64) % 7)
    pos = (cell[:, 0] * 7 + cell[:, 1]) * 13 % cfg.n_candidates
    return {"user_feats": feats, "pos_item": pos.astype(np.int32)}
