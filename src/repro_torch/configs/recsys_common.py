"""The recsys family's input shapes, copied from the JAX package's
``configs/recsys_common.py`` (its dry-run bundle builders wait for
ROADMAP item 7).

  train_batch     batch 65,536            -> train_step
  serve_p99       batch 512               -> ranking forward (online)
  serve_bulk      batch 262,144           -> ranking forward (offline)
  retrieval_cand  1 query x 1M candidates -> stage-1 retrieval + top-k
"""

from __future__ import annotations

__all__ = ["RECSYS_SHAPES"]

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieve", batch=1,
                           n_candidates=1_000_000, k=1000),
}
