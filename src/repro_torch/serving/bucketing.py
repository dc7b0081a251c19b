"""Class-bucketed batching (numpy copy of ``repro.serving.bucketing``).

``bucketize``/``scatter_back`` are the per-bucket execution model kept as
the reference path; ``pad_length``/``pad_rows`` are the whole-batch
padding grid of the batch-once engine.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bucketize", "scatter_back", "pad_length", "pad_rows"]


def pad_length(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= n."""
    return n + (-n) % multiple


def pad_rows(arr: np.ndarray, multiple: int, fill) -> np.ndarray:
    """Pad axis 0 of ``arr`` to the pad grid with constant ``fill`` rows
    (-1 query terms gather no postings and rank to all -1)."""
    arr = np.asarray(arr)
    pad = pad_length(arr.shape[0], multiple) - arr.shape[0]
    if pad == 0:
        return arr
    width = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, width, constant_values=fill)


def bucketize(pred_class: np.ndarray, n_classes: int,
              pad_multiple: int = 8) -> dict[int, dict]:
    """Group query indices by predicted class: {class: {"idx": original
    positions, "pad_idx": padded to pad_multiple (repeats last)}}."""
    out = {}
    pred_class = np.asarray(pred_class)
    for c in range(n_classes + 1):
        idx = np.flatnonzero(pred_class == c)
        if len(idx) == 0:
            continue
        m = len(idx)
        pad = pad_length(m, pad_multiple) - m
        pad_idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
        out[int(c)] = {"idx": idx, "pad_idx": pad_idx}
    return out


def scatter_back(n_queries: int, buckets: dict[int, dict],
                 per_bucket: dict[int, np.ndarray]) -> np.ndarray:
    """Reassemble per-query results from bucket outputs."""
    sample = next(iter(per_bucket.values()))
    out = np.zeros((n_queries, *sample.shape[1:]), sample.dtype)
    for c, b in buckets.items():
        m = len(b["idx"])
        out[b["idx"]] = np.asarray(per_bucket[c])[:m]
    return out
