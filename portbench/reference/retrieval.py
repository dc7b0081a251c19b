"""Score-at-a-time retrieval, pool selection and the second stage.

Stage 1 (JASS): each query term's first ``cap`` postings in impact
order, merged into one impact-descending stream (ties: term order, then
posting order); the first rho postings added into a dense document
accumulator; the pool is the top documents by (score descending, doc
ascending) with a positive score.  Stage 2: per scorer the sum over the
query terms' first ``cap`` postings (terms added in query order), each
sum normalized by its min and max over the collection, mixed with a
length prior and a seeded per-(query, doc) hash; the final list is the
pool ranked by that score (ties: lower doc).  MED-RBP compares two
lists for the envelope labels.  PyTorch on any device, in a chosen
precision (the lower-precision control runs in bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _postings(ix, terms, cap):
    q = terms.clamp(min=0).long()
    start = ix["offsets"][q]
    end = torch.where(terms >= 0, ix["offsets"][q + 1], start)
    idx = start[..., None] + torch.arange(cap, device=terms.device)
    valid = idx < end[..., None]
    return idx.clamp(0, ix["doc"].shape[0] - 1), valid


def stream(ix, terms, cap):
    """(docs (Q, cap) int64, impacts (Q, cap) float32), -1 padded."""
    idx, valid = _postings(ix, terms, cap)
    docs = torch.where(valid, ix["doc"][idx].long(), -1).flatten(1)
    imps = torch.where(valid, ix["impact"][idx], -1.0).flatten(1)
    order = torch.sort(imps, dim=1, descending=True,
                       stable=True).indices[:, :cap]
    return docs.gather(1, order), imps.gather(1, order)


def accumulate(docs, imps, rho, n_docs, dtype=torch.float32):
    """Dense (Q, n_docs) sums of each stream's first ``rho[q]`` postings."""
    pos = torch.arange(docs.shape[1], device=docs.device)
    live = (pos[None, :] < rho[:, None]) & (docs >= 0)
    add = torch.where(live, imps, 0.0).to(dtype)
    acc = torch.zeros((docs.shape[0], n_docs), dtype=dtype,
                      device=docs.device)
    return acc.scatter_add_(1, docs.clamp(min=0), add)


def top_docs(scores, width):
    """(Q, width) doc ids by score descending, ties to the lower doc; -1
    where the score is not positive."""
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :width]
    keep = scores.gather(1, order) > 0
    return torch.where(keep, order, -1)


def prefix(pool, width):
    """Each row's first ``width[q]`` entries, -1 after."""
    pos = torch.arange(pool.shape[1], device=pool.device)
    return torch.where(pos[None, :] < width[:, None], pool, -1)


def _mul32(a, c):
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def hash_noise(docs, qids, seed=11):
    """Per-(query, doc) value in [0, 1): a 32-bit multiply/xor-shift hash."""
    d = docs.long() & _M32
    q = qids.long() & _M32
    h = (_mul32(d, 2654435761) ^ _mul32(q, 40503)) ^ (seed & _M32)
    h = _mul32(h ^ (h >> 15), 2246822519)
    h = h ^ (h >> 13)
    return (h & 0xFFFF).to(torch.float32) / 65536.0


def stage2(ix, terms, cap, qids, dtype=torch.float32):
    """Dense (Q, n_docs) second-stage scores; ``qids`` key the hash."""
    idx, valid = _postings(ix, terms, cap)          # (Q, L, cap)
    docs = torch.where(valid, ix["doc"][idx].long(), 0)
    s3 = torch.where(valid[..., None], ix["score"][idx], 0.0).to(dtype)
    n_docs = ix["doc_len"].shape[0]
    acc = torch.zeros((terms.shape[0], n_docs, 3), dtype=dtype,
                      device=terms.device)
    for t in range(terms.shape[1]):
        acc.scatter_add_(1, docs[:, t, :, None].expand(-1, -1, 3), s3[:, t])

    def norm(x):
        lo = x.amin(dim=-1, keepdim=True)
        hi = x.amax(dim=-1, keepdim=True)
        return (x - lo) / torch.clamp(hi - lo, min=1e-9)

    prior = (1.0 / torch.log(2.0 + ix["doc_len"].to(torch.float32))).to(
        dtype)
    noise = hash_noise(torch.arange(n_docs, device=terms.device)[None, :],
                       qids[:, None]).to(dtype)
    return (0.45 * norm(acc[..., 0]) + 0.25 * norm(acc[..., 1])
            + 0.15 * norm(acc[..., 2]) + 0.05 * prior[None, :]
            + 0.35 * noise)


def rerank(scores, pool, depth):
    """The pool's documents by ``scores`` descending, ties to the lower
    doc: (Q, depth), -1 past the pool's live members."""
    live = pool >= 0
    s = torch.where(live, scores.gather(1, pool.clamp(min=0)),
                    float("-inf"))
    by_doc = torch.sort(pool, dim=1, stable=True).indices
    s, p = s.gather(1, by_doc), pool.gather(1, by_doc)
    order = torch.sort(-s, dim=1, stable=True).indices[:, :depth]
    out = torch.where(s.gather(1, order) > float("-inf"), p.gather(1, order),
                      -1)
    if out.shape[1] < depth:
        out = torch.nn.functional.pad(out, (0, depth - out.shape[1]),
                                      value=-1)
    return out


def _rbp_weights(depth, p, device):
    i = np.arange(depth, dtype=np.float64)
    return torch.from_numpy(((1.0 - p) * p ** i).astype(np.float32)).to(
        device)


def _one_sided(a, b, wa, wb, n_docs):
    rank_b = torch.full((a.shape[0], n_docs + 1), -1, dtype=torch.long,
                        device=a.device)
    pos = torch.arange(b.shape[1], device=a.device).expand_as(b)
    rank_b.scatter_(1, torch.where(b >= 0, b, n_docs), pos)
    rb = rank_b.gather(1, torch.where(a >= 0, a, n_docs))
    w_a = torch.where(a >= 0, wa[None, :], 0.0)
    w_b = torch.where(rb >= 0, wb[rb.clamp(min=0)], 0.0)
    return torch.clamp(w_a - w_b, min=0.0).sum(dim=1)


def med_rbp(a, b, n_docs, p=0.95):
    """MED under rank-biased precision between -1 padded lists: (Q,)."""
    wa = _rbp_weights(a.shape[1], p, a.device)
    wb = _rbp_weights(b.shape[1], p, a.device)
    return torch.maximum(_one_sided(a, b, wa, wb, n_docs),
                         _one_sided(b, a, wb, wa, n_docs))


def envelope_labels(ix, terms, *, knob, cutoffs, cap, pool_depth,
                    gold_depth, tau, rbp_p, batch=128):
    """Per query the first cutoff whose run is within MED-RBP ``tau`` of
    the gold run, else len(cutoffs).  rho: the gold run is the exhaustive
    stage-1 ranking, a candidate the ranking after rho postings.  k: the
    gold run is stage 2 over the exhaustive pool of ``pool_depth``, a
    candidate stage 2 over that pool's first k."""
    n_docs = ix["doc_len"].shape[0]
    dev = ix["doc"].device
    out = []
    for s in range(0, terms.shape[0], batch):
        qt = torch.from_numpy(terms[s:s + batch]).to(dev)
        docs, imps = stream(ix, qt, cap)
        full = torch.full((qt.shape[0],), cap, device=dev)
        acc = accumulate(docs, imps, full, n_docs)
        meds = []
        if knob == "rho":
            gold = top_docs(acc, gold_depth)
            for rho in cutoffs:
                part = accumulate(docs, imps, torch.full_like(full, rho),
                                  n_docs)
                meds.append(med_rbp(gold, top_docs(part, gold_depth),
                                    n_docs, rbp_p))
        else:
            pool = top_docs(acc, min(pool_depth, n_docs))
            qids = torch.arange(qt.shape[0], device=dev)
            s2 = stage2(ix, qt, cap, qids)
            gold = rerank(s2, pool, gold_depth)
            for k in cutoffs:
                cand = rerank(s2, prefix(pool, torch.full_like(full, k)),
                              gold_depth)
                meds.append(med_rbp(gold, cand, n_docs, rbp_p))
        ok = torch.stack(meds, dim=1) <= tau
        first = ok.to(torch.int32).argmax(dim=1)
        out.append(torch.where(ok.any(dim=1), first, len(cutoffs)).cpu())
    return torch.cat(out).numpy()
