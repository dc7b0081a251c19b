"""The paper's technique on the recsys funnel.

Stage 1 is two-tower retrieval over the candidate universe; stage 2 is a
ranking model (BST).  The knob is the retrieval depth k: the paper's k
with "documents" replaced by "items" and "queries" by "requests".
Labelling is judgment-free, as in the paper: the gold run is the stage-2
ranking of a deep candidate pool, the candidate run its restriction to
the top-k pool, MED_RBP gives the minimal in-envelope k per request, and
the cascade predicts it from pre-retrieval request features (user-vector
statistics and history statistics).  A second knob, the reranking depth,
bounds the same prefix of the stage-1 order.

Where the JAX package maps the stage-2 model over requests (``vmap``),
this module scores one flat batch of B x pool rows.  Entry points take a
``device`` (default ``"cuda"``; no card raises) and take their request
arrays as numpy arrays or tensors.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import cascade as cascade_lib
from repro_torch.core import knobs as knobs_lib
from repro_torch.core import labeling, med
from repro_torch.device import fence, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.recsys import bst as BS
from repro_torch.models.recsys import retrieval_tower as RT
from repro_torch.serving.programs import ProgramCache
from repro_torch.tree import leaves, map_tree, unflatten

__all__ = ["FunnelConfig", "request_features", "funnel_gold_runs",
           "label_requests", "Funnel", "K_CUTOFFS_FUNNEL"]

K_CUTOFFS_FUNNEL = (10, 20, 50, 100, 200, 500, 1000)


@dataclasses.dataclass(frozen=True)
class FunnelConfig:
    tower: RT.TowerConfig
    bst: BS.BSTConfig
    cutoffs: tuple[int, ...] = K_CUTOFFS_FUNNEL
    pool_depth: int = 1000
    eval_depth: int = 50
    tau: float = 0.05
    rbp_p: float = 0.9
    depth_cutoffs: tuple[int, ...] | None = None  # reranking-depth grid
    #                                 (second knob); must end at
    #                                 max(cutoffs), the widest pool a
    #                                 request can be served from, so
    #                                 the top class masks nothing

    def __post_init__(self):
        knobs_lib.KnobSpec("k", tuple(self.cutoffs))
        if self.depth_cutoffs is not None:
            spec = knobs_lib.KnobSpec("depth", tuple(self.depth_cutoffs))
            if spec.reference() != max(self.cutoffs):
                raise ValueError(
                    f"funnel depth grid must end at max(cutoffs)="
                    f"{max(self.cutoffs)}, got {spec.reference()}")


def _as_tensor(x, dtype, device) -> torch.Tensor:
    """``x`` (a tensor or an array) on ``device`` as ``dtype``.  An array
    reaches a card through pinned memory, without waiting on the stream
    (a copy from pageable memory would)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.to(dtype=dtype)


def request_features(user_feats: torch.Tensor,
                     hist_items: torch.Tensor) -> torch.Tensor:
    """Static pre-retrieval request features: the user vector, its mean,
    standard deviation (ddof 0), max and min, the history length and the
    share of distinct items in it.  (B, d) and (B, T) -> (B, d + 6).

    Distinct items are counted after an ascending sort: the -1 padding
    leads, and each distinct item adds one first occurrence."""
    uf = user_feats.to(torch.float32)
    mask = (hist_items >= 0).to(torch.float32)
    hl = mask.sum(dim=1, keepdim=True)
    srt = torch.sort(hist_items, dim=1).values
    first = srt[:, :1] >= 0
    fresh = (srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] >= 0)
    hdiv = torch.cat([first, fresh], dim=1).to(torch.float32).sum(
        dim=1, keepdim=True)
    return torch.cat([
        uf,
        uf.mean(dim=1, keepdim=True), uf.std(dim=1, correction=0,
                                             keepdim=True),
        uf.amax(dim=1, keepdim=True), uf.amin(dim=1, keepdim=True),
        hl, hdiv / hl.clamp(min=1.0),
    ], dim=1)


def _bst_scores(bst_params, bst_cfg: BS.BSTConfig, hist_items, cand,
                stage1, bst_weight: float = 0.3, norm_width=None):
    """Stage-2 scores of each candidate item for each request.

    As in production funnels, the stage-1 score is a stage-2 feature:
    s2 = norm(stage1) + w * tanh(BST(request, item)), with w growing
    with the history's share of real items.  cand: (B, P) item ids (-1
    padded); stage1: (B, P) -> (B, P) scores, -inf where cand is -1.
    ``norm_width`` (B,) restricts each request's min-max normalisation to
    its own top-``norm_width`` prefix, so a request's ranking does not
    depend on the widest k batched with it."""
    b, p = cand.shape
    dev = cand.device
    if norm_width is None:
        norm_width = torch.full((b,), p, dtype=torch.int32, device=dev)
    t = hist_items.shape[1]
    rows = {
        "hist_items": hist_items[:, None, :].expand(b, p, t).reshape(b * p,
                                                                     t),
        "target_item": cand.clamp(min=0).reshape(b * p),
        "profile": torch.zeros((b * p, bst_cfg.n_profile),
                               dtype=torch.float32, device=dev),
    }
    s = BS.bst_logits(bst_params, bst_cfg, rows).reshape(b, p)
    prefix = torch.arange(p, device=dev)[None, :] < norm_width[:, None]
    inf = torch.full((), float("inf"), device=dev)
    lo = torch.where(prefix, stage1, inf).amin(dim=1, keepdim=True)
    hi = torch.where(prefix, stage1, -inf).amax(dim=1, keepdim=True)
    s1n = (stage1 - lo) / (hi - lo).clamp(min=1e-9)
    # richer histories give the behavioural model more say: this is what
    # makes the optimal k request-dependent
    frac = (hist_items >= 0).to(torch.float32).mean(dim=1, keepdim=True)
    w = bst_weight * (0.2 + 2.0 * frac)
    total = s1n + w * torch.tanh(s)
    return torch.where(cand >= 0, total, -inf)


def _rank(ids: torch.Tensor, masked: torch.Tensor, depth: int):
    """The first ``depth`` ids by descending masked score (a stable sort:
    ties keep pool order), -1 where the score is -inf.  int32."""
    order = torch.sort(-masked, dim=1, stable=True).indices[:, :depth]
    ranked = ids.gather(1, order)
    live = masked.gather(1, order) > float("-inf")
    return torch.where(live, ranked, torch.full_like(ranked, -1)).to(
        torch.int32)


def funnel_gold_runs(cfg: FunnelConfig, tower_params, bst_params,
                     user_feats, hist_items, cutoffs=None):
    """Gold run (stage 2 over the deep pool) and one candidate run per
    cutoff, on the device of the parameters.  ``cutoffs`` defaults to the
    k grid; another knob's grid (``cfg.depth_cutoffs``) gives that knob's
    runs through the same prefix mask.  Returns (gold (B, eval_depth)
    int32, {cutoff: run})."""
    dev = tower_params["items"].device
    uf = _as_tensor(user_feats, torch.float32, dev)
    hist = _as_tensor(hist_items, torch.int32, dev)
    pool_ids, pool_vals = RT.retrieve_topk(tower_params, cfg.tower, uf,
                                           cfg.pool_depth)
    s2 = _bst_scores(bst_params, cfg.bst, hist, pool_ids, pool_vals)
    pos = torch.arange(cfg.pool_depth, device=dev)[None, :]

    def rank(prefix_k: int):
        masked = torch.where(pos < prefix_k, s2,
                             torch.full((), float("-inf"), device=dev))
        return _rank(pool_ids, masked, cfg.eval_depth)

    cuts = cfg.cutoffs if cutoffs is None else tuple(cutoffs)
    return rank(cfg.pool_depth), {k: rank(k) for k in cuts}


def label_requests(cfg: FunnelConfig, gold, runs, cutoffs=None):
    """(labels (B,) int32, MED_RBP table (B, c)) as numpy arrays: the
    minimal in-envelope cutoff index per request, or c."""
    cuts = cfg.cutoffs if cutoffs is None else tuple(cutoffs)
    table = torch.stack([med.med_rbp(gold, runs[k], p=cfg.rbp_p)
                         for k in cuts], dim=1)
    labels = labeling.envelope_labels(table, cfg.tau)
    return labels.cpu().numpy(), table.cpu().numpy()


def _stage_funnel(user_feats, hist_items, k_vec, depth_vec, *params,
                  tower_like, bst_like, tower_cfg: RT.TowerConfig,
                  bst_cfg: BS.BSTConfig, max_k: int, eval_depth: int):
    """Batch-once funnel serving, the stage the funnel's program cache
    captures: the towers and the stage-2 model run once at a shared pool
    width ``max_k`` (the largest predicted cutoff of the batch); each
    request's served prefix min(k, depth) is a mask over that pool, and
    its stage-1 normalisation spans only that prefix, so its ranking
    does not depend on the rest of the batch.  ``params`` are the tower's
    leaves, then the BST's (``tree.leaves`` order; ``tower_like`` and
    ``bst_like`` give the trees).  Returns the ranked (B, min(max_k,
    eval_depth)) int32 ids, -1 past a request's prefix."""
    n = len(leaves(tower_like))
    tower = unflatten(tower_like, list(params[:n]))
    bst = unflatten(bst_like, list(params[n:]))
    eff = torch.minimum(k_vec, depth_vec)
    ids, vals = RT.retrieve_topk(tower, tower_cfg, user_feats, max_k)
    s2 = _bst_scores(bst, bst_cfg, hist_items, ids, vals, norm_width=eff)
    return _served_rank(ids, s2, eff, eval_depth)


def _served_rank(ids, s2, eff, eval_depth: int):
    """The ranked lists of a shared pool ``ids`` (B, P): each request's
    prefix of ``eff`` items ranked by ``s2``, -1 past it."""
    masked = torch.where(
        torch.arange(ids.shape[1], device=ids.device)[None, :]
        < eff[:, None], s2, torch.full((), float("-inf"), device=ids.device))
    return _rank(ids, masked, eval_depth)


@dataclasses.dataclass
class Funnel:
    """The served funnel.  Parameters and cascades move to ``device``
    (default ``"cuda"``) when the funnel is built.  On the card, float32
    products must run in full float32 (``layers.full_fp32_matmul``, set
    once by the program): building the funnel raises otherwise.

    ``execute`` runs ``_stage_funnel`` as a program of the funnel's
    ``ProgramCache`` (``programs``): one a padded batch and pool width
    ``max_k``, as the JAX package's jitted ``_serve_single_dispatch``
    compiles one executable a batch shape and ``max_k``.  On a card each
    is a CUDA graph, built by the first call at its key and replayed
    after that; the parameters are its constants, read in place.  All
    of them share one graph pool (``one_pool``): the intermediates of
    the widest program (gigabytes at batch 128 and ``max_k`` 1000 at
    the served width) are held once, not once a padded batch.
    ``programs.clear()`` drops them.  A failed build or replay raises."""

    cfg: FunnelConfig
    tower_params: dict
    bst_params: dict
    cascade: cascade_lib.Cascade
    threshold: float = 0.75
    depth_cascade: cascade_lib.Cascade | None = None
    device: torch.device | str | None = None

    def __post_init__(self):
        if (self.depth_cascade is not None
                and self.cfg.depth_cutoffs is None):
            raise ValueError("depth_cascade given but cfg.depth_cutoffs "
                             "is None: declare the depth grid")
        self.device = resolve_device(self.device)
        L.check_full_fp32_matmul(self.device)
        self.tower_params = L.to_device(self.tower_params, self.device)
        self.bst_params = L.to_device(self.bst_params, self.device)
        self.cascade = self.cascade.to(self.device)
        if self.depth_cascade is not None:
            self.depth_cascade = self.depth_cascade.to(self.device)
        self._params = (tuple(leaves(self.tower_params))
                        + tuple(leaves(self.bst_params)))
        self.programs = ProgramCache(self.device, consts=self._params,
                                     one_pool=True)
        self._static = dict(
            tower_like=map_tree(lambda _: None, self.tower_params),
            bst_like=map_tree(lambda _: None, self.bst_params),
            tower_cfg=self.cfg.tower, bst_cfg=self.cfg.bst,
            eval_depth=self.cfg.eval_depth)

    # ``predict`` is the admission-side cascade, ``execute`` the stage-1/2
    # funnel proper.

    @property
    def has_depth_knob(self) -> bool:
        return self.cfg.depth_cutoffs is not None

    @property
    def n_compiles(self) -> int:
        """Programs built: one a padded batch and ``max_k`` (the JAX
        ``_serve_single_dispatch._cache_size()`` on the same calls)."""
        return self.programs.built()

    def predict(self, user_feats, hist_items, knob: str = "k") -> np.ndarray:
        """Pre-retrieval features -> predicted class per request, for the
        named knob.  A declared depth knob with no cascade predicts the
        no-envelope class (full depth, a no-op mask)."""
        casc = self.cascade if knob == "k" else self.depth_cascade
        if knob == "depth" and casc is None:
            return np.full(len(user_feats), len(self.cfg.depth_cutoffs),
                           np.int32)
        feats = request_features(
            _as_tensor(user_feats, torch.float32, self.device),
            _as_tensor(hist_items, torch.int32, self.device))
        return cascade_lib.predict_batched(
            casc, feats, self.threshold).cpu().numpy()

    def params_of(self, classes: np.ndarray, knob: str = "k") -> np.ndarray:
        cuts = (self.cfg.cutoffs if knob == "k"
                else self.cfg.depth_cutoffs)
        return knobs_lib.KnobSpec(knob, tuple(cuts)).params_of(classes)

    def stage_call(self, user_feats, hist_items, ks: np.ndarray,
                   depths: np.ndarray) -> tuple:
        """(program name, tensor arguments, static keywords) of
        ``_stage_funnel`` for one batch at pool cutoffs ``ks`` and
        reranking depths ``depths``: ``_stage_funnel(*args, **kwargs)``
        is the program's eager run."""
        dev = self.device
        args = (_as_tensor(user_feats, torch.float32, dev),
                _as_tensor(hist_items, torch.int32, dev),
                _as_tensor(ks, torch.int64, dev),
                _as_tensor(depths, torch.int64, dev)) + self._params
        max_k = int(ks.max())
        return (f"funnel:{max_k}", args, dict(self._static, max_k=max_k))

    def execute(self, user_feats, hist_items, classes: np.ndarray,
                depth_classes: np.ndarray | None = None) -> dict:
        """Run the funnel at the predicted per-request pool cutoffs and
        (when the depth knob is live) reranking depths: the program of
        the batch's size and largest k, and the one copy of its ranked
        lists to the host (``timings``: ``execute_ms``, host clock)."""
        ks = self.params_of(np.asarray(classes))
        if depth_classes is not None:
            depths = self.params_of(np.asarray(depth_classes), knob="depth")
        else:
            # depth knob off: every request at the full pool (no-op mask)
            depths = np.full_like(ks, max(self.cfg.cutoffs))
        t0 = time.perf_counter()
        name, args, kwargs = self.stage_call(user_feats, hist_items, ks,
                                             depths)
        prog = self.programs.compiled(name, _stage_funnel, args, kwargs)
        ranked = prog(*args).cpu().numpy()
        timings = {"execute_ms": (time.perf_counter() - t0) * 1e3}
        out = np.full((len(ks), self.cfg.eval_depth), -1, np.int32)
        out[:, :ranked.shape[1]] = ranked
        res = {"ranked": out, "k": ks, "classes": np.asarray(classes),
               "mean_k": float(ks.mean()), "timings": timings}
        if depth_classes is not None:
            res["depths"] = depths
            res["depth_classes"] = np.asarray(depth_classes)
        return res

    def serve(self, user_feats, hist_items) -> dict:
        """Predict, then execute; ``timings`` gains predict_ms and
        total_ms (host clock, device-fenced)."""
        fence(self.device)
        t0 = time.perf_counter()
        dcls = (self.predict(user_feats, hist_items, knob="depth")
                if self.has_depth_knob else None)
        classes = self.predict(user_feats, hist_items)
        t1 = time.perf_counter()
        res = self.execute(user_feats, hist_items, classes,
                           depth_classes=dcls)
        res["timings"]["predict_ms"] = (t1 - t0) * 1e3
        res["timings"]["total_ms"] = (time.perf_counter() - t0) * 1e3
        return res
