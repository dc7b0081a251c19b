"""The multi-stage retrieval pipeline with dynamic trade-off prediction.

    query -> static features (core.features, precomputed term stats)
          -> LR cascade -> predicted class (a k or rho bucket)
          -> batch-once candidate generation (per-query k/rho as data)
          -> second-stage reranker -> final ranked list

Everything after the class prediction runs through the batch-once
``ServingEngine``.  ``serve_batch_reference`` keeps the per-bucket
execution model (one static parameter per class) as the oracle.

Prediction is the JAX server's fused predict: features, the cascade and
the first firing node in one program a knob and padded shape (the
margin has its own), through a ``ProgramCache`` of the server's own
(``predict_programs``): a CUDA graph on a card, the stage function on
the CPU.  The stage functions (``_stage_predict``, ``_stage_margin``)
take every tensor as an argument: the queries, the term statistics
(read in place), the thresholds and the knob's node tables (the leaves
of its per-node parameter trees); the node kind, depth and the trees'
structure go by keyword.  A hot swap installs new tables of the same
shapes and the next call copies them in, so it builds nothing, as the
JAX server's runtime operands.  The predicts are warmed where the JAX server
warms them, and each knob counts the JAX ``_cache_size()``.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core import cascade as cascade_lib
from repro_torch.core import features as feat_lib
from repro_torch.core import knobs as knobs_lib
from repro_torch.device import fence, resolve_device
from repro_torch.obs import NULL_TRACE
from repro_torch.obs import device as obs_device
from repro_torch.retrieval import gold, jass
from repro_torch.serving import bucketing
from repro_torch.serving.engine import (ServingEngine, ShardedServingEngine,
                                       _h2d, _pad_ranked)
from repro_torch.serving.programs import ProgramCache
from repro_torch.tree import leaves, leaves_with_paths, map_tree, unflatten

__all__ = ["ServingConfig", "RetrievalServer"]


@dataclasses.dataclass
class ServingConfig:
    knob: str                      # "k" | "rho"
    cutoffs: tuple[int, ...]       # the 9 parameter values
    threshold: float = 0.75        # cascade confidence t
    rerank_depth: int = 100        # final list depth
    stream_cap: int = 4096         # postings stream length P
    pad_multiple: int = 8
    kernel_block_p: int = 512       # impact_scan posting-block size
    kernel_block_d: int = 2048      # impact_scan doc-tile size
    partition_slack: float = 2.0    # per-shard stream headroom (sharded
    #                               engine: shard stream cap ~= slack *
    #                               cap / n_shards; overflow raises)
    depth_cutoffs: tuple[int, ...] | None = None  # reranking-depth grid
    #                               (third knob); None = depth knob off.
    #                               Must end at depth_pool_width.

    def __post_init__(self):
        if self.knob not in ("rho", "k"):
            raise ValueError(f"knob must be 'rho' or 'k', got "
                             f"{self.knob!r}")
        knobs_lib.KnobSpec(self.knob, tuple(self.cutoffs))  # grid checks
        if self.knob == "k" and self.rerank_depth > max(self.cutoffs):
            raise ValueError(
                f"rerank_depth={self.rerank_depth} exceeds the widest "
                f"candidate pool max(cutoffs)={max(self.cutoffs)}: every "
                "ranked list would be -1-padded past the pool width")
        if self.depth_cutoffs is not None:
            spec = knobs_lib.KnobSpec("depth", tuple(self.depth_cutoffs))
            if spec.reference() != self.depth_pool_width:
                raise ValueError(
                    f"depth grid must end at the candidate-pool width "
                    f"{self.depth_pool_width} (its reference: masking at "
                    f"it is a no-op), got max {spec.reference()}")

    @property
    def depth_pool_width(self) -> int:
        """Static width of the pool the depth knob masks: rerank_depth
        under rho, max(cutoffs) under k."""
        return (self.rerank_depth if self.knob == "rho"
                else max(self.cutoffs))


# ---------------------------------------------------- predict stages --

def _stage_proba0(qt, stats, ctf, df, tables, *, kind: str, max_depth: int,
                  skeleton):
    x = feat_lib.query_features(qt, stats, ctf, df)
    node_params = unflatten(skeleton, list(tables))
    return cascade_lib.proba0_from_params(kind, node_params, x, max_depth)


def _stage_predict(qt, stats, ctf, df, thresholds, *tables, kind: str,
                   max_depth: int, skeleton):
    """Features + cascade + first firing node: (Q,) int32 classes."""
    p0 = _stage_proba0(qt, stats, ctf, df, tables, kind=kind,
                       max_depth=max_depth, skeleton=skeleton)
    return cascade_lib.classes_from_proba(p0, thresholds)


def _stage_margin(qt, stats, ctf, df, thresholds, *tables, kind: str,
                  max_depth: int, skeleton):
    """Features + cascade: (Q,) min over nodes of |p0 - t|."""
    p0 = _stage_proba0(qt, stats, ctf, df, tables, kind=kind,
                       max_depth=max_depth, skeleton=skeleton)
    return (p0 - thresholds[None, :]).abs().amin(dim=1)


def _same_layout(new, old) -> None:
    """Swapped node params (forest tables or MLP states) must match the
    live ones in structure, shapes and dtypes."""
    if len(new) != len(old):
        raise ValueError(f"swapped predictor has {len(new)} nodes, the "
                         f"live one {len(old)}")
    for a, b in zip(new, old):
        fa, fb = leaves_with_paths(a), leaves_with_paths(b)
        if [k for k, _ in fa] != [k for k, _ in fb]:
            raise ValueError("swapped predictor tables differ from the "
                             f"live ones ({[k for k, _ in fa]} vs "
                             f"{[k for k, _ in fb]})")
        for (k, x), (_, y) in zip(fa, fb):
            if x.shape != y.shape or x.dtype != y.dtype:
                raise ValueError(
                    f"swapped predictor table {k!r} mismatch: "
                    f"{tuple(x.shape)}/{x.dtype} vs live "
                    f"{tuple(y.shape)}/{y.dtype} -- pad retrained "
                    "params to the template")


class RetrievalServer:
    """Owns the index-derived tensors + trained cascade; serves batches.

    With a ``mesh`` (``distrib.sharding.DeviceMesh``) the engine is the
    ``ShardedServingEngine``: docs shard over ``shard_axis``, request
    rows over the mesh's data axes, with the same ``serve`` surface and
    the same lists.  ``device`` is where the cascade predicts, through
    ``predict_programs`` (its ``n_compiles`` is the predicts' and
    margins' count; ``engine.n_compiles`` stays the stages')."""

    def __init__(self, index, casc: cascade_lib.Cascade | None,
                 cfg: ServingConfig, *,
                 depth_cascade: cascade_lib.Cascade | None = None,
                 device=None, mesh=None, shard_axis: str = "model",
                 warmup_batch_sizes: tuple[int, ...] = (),
                 warmup_query_len: int = 0):
        self.device = resolve_device(device)
        self.cascade = casc
        self.depth_cascade = depth_cascade
        self.cfg = cfg
        self.knobs = {cfg.knob: knobs_lib.KnobSpec(cfg.knob,
                                                   tuple(cfg.cutoffs))}
        if cfg.depth_cutoffs is not None:
            self.knobs["depth"] = knobs_lib.KnobSpec(
                "depth", tuple(cfg.depth_cutoffs))
        elif depth_cascade is not None:
            raise ValueError(
                "depth_cascade given but cfg.depth_cutoffs is None -- "
                "declare the depth grid in ServingConfig")
        if mesh is not None:
            self.engine = ShardedServingEngine(index, cfg, mesh,
                                               axis=shard_axis)
        else:
            self.engine = ServingEngine(index, cfg, device=self.device)
        ts = index.term_stats
        self.stats = ts.stats.to(self.device)
        self.ctf = ts.ctf.to(self.device)
        self.df = ts.df.to(self.device)
        self.n_docs = index.n_docs
        self.predict_programs = ProgramCache(
            self.device, consts=(self.stats, self.ctf, self.df))
        self._kinds = {}   # knob -> (node kind, max_depth, tree skeleton)
        self._live = {}                # knob -> (node_params, thresholds)
        self._swap_lock = threading.Lock()
        self.predictor_version = 0
        self.trace = NULL_TRACE
        self._dev = None               # the recorder's device timer
        self.fallback = False          # serve every knob at its reference
        if casc is not None:
            self._boot_knob(cfg.knob, casc)
        if depth_cascade is not None:
            self._boot_knob("depth", depth_cascade)
        if warmup_batch_sizes and warmup_query_len:
            self.engine.warmup(warmup_batch_sizes, warmup_query_len,
                               with_depth=self.has_depth_knob)
            for knob in self._kinds:       # the fused predicts, as JAX's
                for b in sorted({self.engine.padded_batch(int(x))
                                 for x in warmup_batch_sizes}):
                    self.predict_classes(
                        np.full((b, warmup_query_len), -1, np.int32),
                        knob=knob)

    def _boot_knob(self, knob: str, casc: cascade_lib.Cascade) -> None:
        """Install a knob's boot cascade (forest or MLP nodes) on the
        server's device; forest tables are padded to the depth-derived
        capacity, so same-depth retrains swap in."""
        if knob not in self.knobs:
            raise ValueError(f"no cutoff grid declared for knob {knob!r}")
        if casc.n_cutoffs != self.knobs[knob].n_cutoffs:
            raise ValueError(
                f"knob {knob!r}: cascade has {casc.n_cutoffs} nodes but "
                f"the grid has {self.knobs[knob].n_cutoffs} cutoffs")
        node_params = cascade_lib.place_node_params(
            casc.kind, casc.node_params, casc.max_depth, self.device)
        thresholds = torch.full((casc.n_cutoffs,), self.cfg.threshold,
                                dtype=torch.float32, device=self.device)
        fence(self.device)   # placed before any other stream reads them
        self._kinds[knob] = (casc.kind, casc.max_depth,
                             map_tree(lambda _: None, node_params))
        with self._swap_lock:
            self._live = {**self._live, knob: (node_params, thresholds)}

    def bind_obs(self, obs) -> None:
        """Attach an observability handle, here and in the engine: while
        its recorder is watched, each predict program's call runs in a
        ``predict.program`` span with its device interval
        (``obs/device.py``)."""
        self.trace = obs.trace
        self._dev = obs_device.timer(obs, self.device)
        self.engine.bind_obs(obs)

    @property
    def has_depth_knob(self) -> bool:
        return "depth" in self.knobs

    def _operands(self, query_terms: np.ndarray, knob: str):
        """(tensor arguments, static keywords) of ``knob``'s predict
        programs on the padded queries, or None when the knob has no
        cascade.  The live tables and thresholds are read together under
        the swap lock, then the program copies them in: a swap between
        two calls gives each batch exactly one version's weights."""
        with self._swap_lock:
            live = self._live.get(knob)
        if live is None:
            return None
        qt = bucketing.pad_rows(query_terms, self.engine.batch_multiple,
                                fill=-1)
        qt = _h2d(qt.astype(np.int32), self.device)
        node_params, thresholds = live
        kind, depth, skeleton = self._kinds[knob]
        return ((qt, self.stats, self.ctf, self.df, thresholds)
                + tuple(leaves(node_params)),
                dict(kind=kind, max_depth=depth, skeleton=skeleton))

    @staticmethod
    def _host(out: torch.Tensor, n: int) -> np.ndarray:
        """A predict's first ``n`` rows on the host: its one copy out."""
        return out[:n].cpu().numpy()

    # stage 0: prediction ------------------------------------------------
    def predict_classes(self, query_terms: np.ndarray,
                        knob: str | None = None) -> np.ndarray:
        """Featurize + cascade, fused into one program a knob and padded
        shape: (n,) classes.

        A declared knob with no cascade installed predicts the
        no-envelope class for every query, which ``params_of`` maps to
        the knob's reference."""
        knob = self.cfg.knob if knob is None else knob
        call = self._operands(query_terms, knob)
        if call is None:
            return np.full(query_terms.shape[0],
                           self.knobs[knob].n_cutoffs, np.int32)
        prog = self.predict_programs.compiled(f"predict:{knob}",
                                              _stage_predict, *call)
        dev = self._dev
        if dev is None or not self.trace.watching:
            out = prog(*call[0])
        else:
            with self.trace.span("predict.program") as sp:
                out = dev.call(sp, prog, *call[0])
        classes = self._host(out, query_terms.shape[0])
        if dev is not None:            # the stream is idle after the copy
            dev.anchor()
        return classes

    def predict_versioned(self, query_terms: np.ndarray,
                          knob: str | None = None):
        """(``predict_classes``' classes, the version of the weights that
        gave them), for the service and the scheduler.  The live tables
        and version are read before the predict and the tables again
        after it; a swap in between runs the predict again (swaps are
        rare), so a batch's classes are never put down to other weights.
        It calls ``predict_classes``, so a stand-in for that serves here
        too."""
        while True:
            with self._swap_lock:
                live, version = self._live, self.predictor_version
            classes = self.predict_classes(query_terms, knob)
            with self._swap_lock:
                if self._live is live:
                    return classes, version

    def predict_margin(self, query_terms: np.ndarray,
                       knob: str | None = None) -> np.ndarray:
        """Per-query cascade uncertainty: min over nodes of |p0 - t|,
        through a program of its own.  Knobs with no cascade report
        zero margin."""
        knob = self.cfg.knob if knob is None else knob
        call = self._operands(query_terms, knob)
        if call is None:
            return np.zeros(query_terms.shape[0], np.float32)
        prog = self.predict_programs.compiled(f"margin:{knob}",
                                              _stage_margin, *call)
        return self._host(prog(*call[0]), query_terms.shape[0])

    def swap_predictor(self, node_params, thresholds=None, *,
                       version: int | None = None,
                       knob: str | None = None) -> int:
        """Atomically replace a knob's live cascade tables (and optionally
        its per-node thresholds).  The new tables must match the live
        ones in structure, shapes and dtypes (``online.PredictorStore``
        pads retrained forests to the template).  The predict programs
        copy the new tables in at their next call and build nothing."""
        knob = self.cfg.knob if knob is None else knob
        if knob not in self._kinds:
            raise RuntimeError(
                f"server has no cascade predict path for knob {knob!r} "
                "to swap (no boot cascade was installed for it)")
        new_params = [map_tree(lambda v: torch.as_tensor(v).to(self.device),
                               p) for p in node_params]
        if thresholds is not None:
            thresholds = torch.as_tensor(
                thresholds, dtype=torch.float32).to(self.device)
        fence(self.device)   # placed before any other stream reads them
        with self._swap_lock:
            old_params, old_thr = self._live[knob]
            _same_layout(new_params, old_params)
            if thresholds is None:
                thresholds = old_thr
            elif thresholds.shape != old_thr.shape:
                raise ValueError(
                    f"thresholds shape {tuple(thresholds.shape)} != "
                    f"live {tuple(old_thr.shape)}")
            self._live = {**self._live, knob: (new_params, thresholds)}
            self.predictor_version = (self.predictor_version + 1
                                      if version is None else int(version))
            return self.predictor_version

    def params_of(self, classes: np.ndarray,
                  knob: str | None = None) -> np.ndarray:
        """Predicted class -> engine parameter (k, rho, or depth) via the
        knob's grid; ``fallback`` pins every query to the reference."""
        knob = self.cfg.knob if knob is None else knob
        p = self.knobs[knob].params_of(classes, fallback=self.fallback)
        if knob == "rho":
            p = np.minimum(p, self.cfg.stream_cap)
        return p.astype(np.int64)

    def predict_depths(self, query_terms: np.ndarray):
        """(depth classes, depth vector), or (None, None) when the depth
        knob is off."""
        if not self.has_depth_knob:
            return None, None
        dclasses = self.predict_classes(query_terms, knob="depth")
        return dclasses, self.params_of(dclasses, knob="depth")

    def _rows_scored(self, widths: np.ndarray, depths: np.ndarray):
        """Per-query pool rows admitted into the rerank under the depth
        knob, and the depth-free pool rows."""
        full = (widths if self.cfg.knob == "k"
                else np.full_like(widths, self.cfg.rerank_depth))
        return np.minimum(depths, full), full

    def serve_batch(self, query_terms: np.ndarray) -> dict:
        """Full dynamic pipeline over a query batch, batch-once."""
        t0 = time.perf_counter()
        classes = self.predict_classes(query_terms)
        dclasses, depths = self.predict_depths(query_terms)
        predict_ms = (time.perf_counter() - t0) * 1e3
        widths = self.params_of(classes)
        ranked, timings = self.engine.serve(query_terms, widths,
                                            depth_vec=depths)
        timings["predict_ms"] = predict_ms
        timings["total_ms"] = (time.perf_counter() - t0) * 1e3
        out = {
            "ranked": ranked,
            "classes": classes,
            "mean_param": float(widths.mean()),
            "widths": widths.astype(np.float64),
            "timings": timings,
            "n_compiles": self.engine.n_compiles,
        }
        if depths is not None:
            rows, full = self._rows_scored(widths, depths)
            out["depth_classes"] = dclasses
            out["depths"] = depths.astype(np.float64)
            out["stage2_rows_scored"] = int(rows.sum())
            out["stage2_rows_full"] = int(full.sum())
        return out

    def serve_fixed(self, query_terms: np.ndarray, param: int, *,
                    depth: int | None = None) -> dict:
        """Fixed-global-parameter baseline through the same engine."""
        t0 = time.perf_counter()
        n = query_terms.shape[0]
        pool_width = None
        if self.cfg.knob == "rho":
            param = min(param, self.cfg.stream_cap)
        elif param > self.engine.max_k:
            pool_width = param       # wider than the shared pool
        widths = np.full(n, param, np.int64)
        dvec = None if depth is None else np.full(n, int(depth), np.int64)
        ranked, timings = self.engine.serve(query_terms, widths,
                                            pool_width=pool_width,
                                            depth_vec=dvec)
        timings["predict_ms"] = 0.0
        timings["total_ms"] = (time.perf_counter() - t0) * 1e3
        return {"ranked": ranked, "mean_param": float(param),
                "widths": widths.astype(np.float64), "timings": timings,
                "n_compiles": self.engine.n_compiles}

    # ------------------------------------------- reference (per-bucket) --
    def _serve_bucket(self, query_terms: np.ndarray, param: int,
                      qids: np.ndarray):
        """Per-bucket path at one static parameter: re-gathers streams and
        re-materializes the stage-2 accumulators on every call."""
        eng = self.engine
        qt = torch.from_numpy(query_terms.astype(np.int32)).to(self.device)
        ds, im = jass.gather_streams(eng.offsets, eng.pdoc, eng.pimp, qt,
                                     cap=self.cfg.stream_cap)
        if self.cfg.knob == "rho":
            rho = min(param, self.cfg.stream_cap)
            acc = jass.saat_scores(ds, im, self.n_docs, rho)
            pool = jass.rank_from_scores(acc, self.cfg.rerank_depth)
            width = rho
        else:
            acc = jass.saat_scores(ds, im, self.n_docs, ds.shape[-1])
            pool = jass.rank_from_scores(acc, param)
            width = param
        sdocs, s3 = jass.gather_score_streams(eng.offsets, eng.pdoc,
                                              eng.pscore, qt,
                                              cap=self.cfg.stream_cap)
        a_bm25, a_lm, a_tfidf = jass.scorer_accumulators(
            sdocs, s3, self.n_docs, n_terms=qt.shape[1])
        stage2 = gold.second_stage_scores(
            a_bm25, a_lm, a_tfidf, eng.doc_len,
            torch.from_numpy(qids).to(self.device))
        ranked = gold.rerank_pool(stage2, pool, self.cfg.rerank_depth)
        return _pad_ranked(ranked.cpu().numpy(), self.cfg.rerank_depth), width

    def serve_batch_reference(self, query_terms: np.ndarray) -> dict:
        """Per-bucket execution model: one static-parameter pass per
        predicted class."""
        n = query_terms.shape[0]
        classes = self.predict_classes(query_terms)
        buckets = bucketing.bucketize(classes, len(self.cfg.cutoffs),
                                      self.cfg.pad_multiple)
        results, widths = {}, np.zeros(n)
        for c, b in buckets.items():
            param = self.cfg.cutoffs[min(c, len(self.cfg.cutoffs) - 1)]
            ranked, width = self._serve_bucket(query_terms[b["pad_idx"]],
                                               int(param), b["pad_idx"])
            results[c] = ranked
            widths[b["idx"]] = width
        return {
            "ranked": bucketing.scatter_back(n, buckets, results),
            "classes": classes,
            "mean_param": float(widths.mean()),
            "widths": widths,
        }
