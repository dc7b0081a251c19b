"""How ``correct`` is decided: the served answers against the plain
reference, recomputed from the benchmark's own inputs.

For each sampled request the reference works out the class (features,
then the cascade), the stage-1 pool at that class's width and the final
list (stage 2, then the rerank), with the request's batch row as the
stage-2 hash key.  Three numbers are compared, each with a limit of its
own from the configuration file:

* ``class_mismatch``: share of sampled requests whose served class is
  not the reference's;
* ``pool_miss``: share of list positions where the served document is
  not in the reference's pool, or one list is exhausted and the other
  not;
* ``score_gap``: the widest gap by which the reference's second-stage
  score of a served document lies below that of the reference's
  document at the same position.

The control runs the reference in bfloat16 in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import features as ref_feat
from portbench.reference import forest as ref_forest
from portbench.reference import retrieval as ref_ret

NAMES = ("class_mismatch", "pool_miss", "score_gap")


def widths(cfg: dict, classes: np.ndarray) -> np.ndarray:
    """Class -> the knob's parameter: cutoffs[min(class, c - 1)]."""
    cuts = np.asarray(cfg["cutoffs"], np.int64)
    w = cuts[np.minimum(np.asarray(classes), len(cuts) - 1)]
    return np.minimum(w, cfg["stream_cap"]) if cfg["knob"] == "rho" else w


def reference(ix: dict, cascade: list, cfg: dict, terms: torch.Tensor,
              qids: torch.Tensor, dtype=torch.float32) -> dict:
    """Classes, pool, dense stage-2 scores and final lists of one block
    of queries, every float computed in ``dtype``."""
    n_docs = ix["doc_len"].shape[0]
    cap = cfg["stream_cap"]
    x = ref_feat.features(terms, ix["stats"], ix["ctf"], ix["df"], dtype)
    cls = ref_forest.classes(cascade, x, max_depth=cfg["forest"]["max_depth"],
                             threshold=cfg["threshold"])
    width = torch.from_numpy(widths(cfg, cls.cpu().numpy())).to(terms.device)
    docs, imps = ref_ret.stream(ix, terms, cap)
    if cfg["knob"] == "rho":
        acc = ref_ret.accumulate(docs, imps, width, n_docs, dtype)
        pool = ref_ret.top_docs(acc, cfg["rerank_depth"])
    else:
        full = torch.full_like(width, cap)
        acc = ref_ret.accumulate(docs, imps, full, n_docs, dtype)
        pool = ref_ret.prefix(ref_ret.top_docs(acc, max(cfg["cutoffs"])),
                              width)
    s2 = ref_ret.stage2(ix, terms, cap, qids, dtype)
    return dict(classes=cls, pool=pool, s2=s2,
                lists=ref_ret.rerank(s2, pool, cfg["rerank_depth"]))


def compare(ref: dict, classes: torch.Tensor, lists: torch.Tensor):
    """(class mismatches, pool misses, positions, widest score gap) of
    served ``classes`` (B,) and ``lists`` (B, depth) against ``ref``."""
    n_docs = ref["s2"].shape[1]
    pool = ref["pool"]
    member = torch.zeros((pool.shape[0], n_docs + 1), dtype=torch.bool,
                         device=pool.device)
    member.scatter_(1, torch.where(pool >= 0, pool, n_docs), True)
    member[:, n_docs] = False
    got, want = lists.long(), ref["lists"]
    miss = (((got >= 0) & ~member.gather(1, got.clamp(min=0)))
            | ((got < 0) != (want < 0)))
    both = (got >= 0) & (want >= 0)
    s2 = ref["s2"].float()
    gap = torch.where(both, s2.gather(1, want.clamp(min=0))
                      - s2.gather(1, got.clamp(min=0)), 0.0)
    return (int((ref["classes"] != classes.long()).sum()), int(miss.sum()),
            miss.numel(), max(0.0, float(gap.max())) if gap.numel() else 0.0)


def judge(ix: dict, cascade: list, cfg: dict, terms: np.ndarray,
          qids: np.ndarray, classes: np.ndarray | None = None,
          lists: np.ndarray | None = None, *, control: bool = False,
          block: int = 128) -> dict:
    """The three numbers over a sample, in blocks of ``block`` rows.
    Served ``classes`` and ``lists`` are judged; with ``control`` the
    reference computed in bfloat16 stands in their place."""
    dev = ix["doc"].device
    n_mis = n_miss = n_pos = 0
    gap = 0.0
    for s in range(0, terms.shape[0], block):
        qt = torch.from_numpy(np.ascontiguousarray(terms[s:s + block])).to(
            dev)
        q = torch.from_numpy(np.asarray(qids[s:s + block], np.int64)).to(dev)
        ref = reference(ix, cascade, cfg, qt, q)
        if control:
            low = reference(ix, cascade, cfg, qt, q, torch.bfloat16)
            got_c, got_l = low["classes"], low["lists"]
        else:
            got_c = torch.from_numpy(np.asarray(classes[s:s + block])).to(dev)
            got_l = torch.from_numpy(np.asarray(lists[s:s + block])).to(dev)
        a, b, c, g = compare(ref, got_c, got_l)
        n_mis, n_miss, n_pos, gap = n_mis + a, n_miss + b, n_pos + c, max(
            gap, g)
    return dict(class_mismatch=n_mis / max(terms.shape[0], 1),
                pool_miss=n_miss / max(n_pos, 1), score_gap=gap)


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NAMES)
