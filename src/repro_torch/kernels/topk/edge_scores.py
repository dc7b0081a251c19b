"""Seeded score rows at the edges of the top-k kernel's contract,
defined once for ``chip_smoke.py`` and the port's kernel tests."""

from __future__ import annotations

import numpy as np

__all__ = ["KINDS", "edge_scores"]

#: score rows that pin the top-k kernel's contract
KINDS = ("stage1", "signed_zeros", "neg_inf_inside", "all_neg_inf")


def edge_scores(kind: str, q: int, n: int, seed: int) -> np.ndarray:
    """(q, n) float32 scores of one kind:

    * ``stage1``: what ``impact_scan`` hands ``topk`` at small rho:
      integer-valued, 99% zeros, so thousands of zeros tie at the kp-th
      value of a 4096-wide block;
    * ``signed_zeros``: mostly -0.0 and +0.0, which compare equal;
    * ``neg_inf_inside``: real -inf scores among rounded normals, and a
      first row with fewer finite scores than kp in each block;
    * ``all_neg_inf``: nothing but -inf.
    """
    r = np.random.default_rng(seed)
    if kind == "stage1":
        s = np.zeros((q, n), np.float32)
        live = r.random((q, n)) < 0.01
        s[live] = r.integers(1, 20, int(live.sum()))
    elif kind == "signed_zeros":
        s = r.choice([-0.0, 0.0, 1.0, -1.0, 3.0], (q, n),
                     p=[0.4, 0.4, 0.08, 0.08, 0.04]).astype(np.float32)
    elif kind == "neg_inf_inside":
        s = np.round(r.normal(size=(q, n)) * 4).astype(np.float32)
        s[r.random((q, n)) < 0.2] = -np.inf
        s[0, r.random(n) < 0.99] = -np.inf
    elif kind == "all_neg_inf":
        s = np.full((q, n), -np.inf, np.float32)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return s
