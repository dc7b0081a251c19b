"""End-to-end multi-stage serving through the unified RetrievalService,
on the port (the driver of the JAX package's
``examples/serve_retrieval.py``: same sizes, flags and output lines).

Spins up the full runtime: featurizer -> LR cascade -> single-dispatch
candidate generation (k or rho knob) -> second-stage rerank, behind the
async front door: per-request deadlines, a deadline-ordered admission
queue over the pad grid, prediction/dispatch overlap, and the warmup
policy.  Compares dynamic vs fixed-parameter serving on throughput,
mean parameter, and early-precision agreement.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_retrieval \
          [--knob rho] [--online] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the CPU; with
no card and no ``--device`` it raises ``RuntimeError``.

``--online`` adds the adaptation-loop demo: the query distribution
shifts (short queries -> verbose multi-term queries), the frozen cascade
starts serving outside its effectiveness envelope, and the online loop
(telemetry -> idle-capacity shadow labeling against the system's own
full-fidelity run -> sliding-window retrains -> hot-swapped weights)
pulls realized MED back toward the envelope with no relevance
judgments.  ``--trace-out`` (default under the git-ignored ``build/``)
receives a Perfetto trace of that replay ('' disables it).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def online_demo(sys_, server, service, args) -> None:
    from repro_torch.core import tradeoff
    from repro_torch.obs import export as obs_export
    from repro_torch.online import (OnlineConfig, OnlineController,
                                    TelemetryBuffer, TrainerConfig, replay,
                                    serving_med_table, shifted_queries)

    print("\n== online adaptation: the query distribution shifts ==")
    service.telemetry = TelemetryBuffer()
    shifted = shifted_queries(sys_.corpus, 384, band="long",
                              max_len=sys_.queries.terms.shape[1])
    adapt_qt, eval_qt = shifted.terms[:256], shifted.terms[256:]
    med_eval = serving_med_table(server, eval_qt, batch=128)
    cuts = np.asarray(server.cfg.cutoffs)

    def score(classes, label):
        med = float(tradeoff.realized_med(med_eval, classes).mean())
        k = tradeoff.mean_cutoff_value(classes, cuts)
        flag = "IN" if med <= args.tau else "OUT of"
        print(f"  {label:<22} MED={med:.4f} ({flag} envelope "
              f"tau={args.tau})  mean_{server.cfg.knob}={k:.0f}")
        return med

    before = score(server.predict_classes(eval_qt), "frozen cascade")
    ctrl = OnlineController(service, server, OnlineConfig(
        tau=args.tau, shadow_sample=128,
        trainer=TrainerConfig(min_labels=128, retrain_every=128,
                              window=1024,
                              forest_kwargs=dict(n_trees=8, max_depth=6))))
    n0 = server.engine.n_compiles
    obs = service.obs
    obs.trace.clear()                     # trace the replay only
    replay(service, adapt_qt, chunk=128, controller=ctrl)
    replay(service, adapt_qt, chunk=128, controller=ctrl)  # second pass:
    # the shadow sampler labels what the first pass only served
    after = score(server.predict_classes(eval_qt),
                  f"adapted (v{server.predictor_version})")
    st = ctrl.stats()
    print(f"  loop: {st['n_labels']} shadow labels (no relevance "
          f"judgments), {st['n_retrains']} retrains, {st['n_swaps']} "
          f"hot-swaps, {server.engine.n_compiles - n0} extra engine "
          f"compiles, recovered "
          f"{(before - after) / max(before, 1e-9):.0%} of the drift")

    if obs.enabled and args.trace_out:
        # the same run, seen through the trace: export the Perfetto
        # JSON and join one query's spans to its telemetry record
        os.makedirs(os.path.dirname(args.trace_out) or ".", exist_ok=True)
        payload = obs_export.write_chrome_trace(args.trace_out, obs.trace)
        n_x = sum(1 for e in payload["traceEvents"] if e["ph"] == "X")
        kinds = sorted({e["name"] for e in payload["traceEvents"]
                        if e["ph"] == "X"})
        print(f"\n== trace of the replay ==\n  {n_x} spans -> "
              f"{args.trace_out}\n  kinds: {', '.join(kinds)}")
        recs = [r for r in service.telemetry.snapshot()
                if r.trace_id >= 0]
        if recs:
            att = obs_export.latency_attribution(obs.trace,
                                                 recs[-1].trace_id)
            print(f"  attribution for trace_id={att['trace_id']}: "
                  f"stages={att['stages']} shared over "
                  f"{len(att['shared'])} batch-scoped span kinds")
        counters = {k: v for k, v in obs.metrics.counters().items()
                    if k.startswith(("online.", "service."))}
        print(f"  counters: {counters}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--knob", default="k", choices=["k", "rho"])
    ap.add_argument("--tau", type=float, default=0.05)
    ap.add_argument("--threshold", type=float, default=0.75)
    ap.add_argument("--deadline-ms", type=float, default=200.0)
    ap.add_argument("--online", action="store_true",
                    help="demo the shadow-label/retrain/hot-swap loop "
                         "under a synthetic distribution shift")
    ap.add_argument("--trace-out",
                    default="build/repro_torch/serve_trace.json",
                    help="with --online: write a Perfetto trace of the "
                         "adaptation replay here ('' disables)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.core import cascade as cascade_lib
    from repro_torch.core import experiment as E
    from repro_torch.core import labeling
    from repro_torch.device import resolve_device
    from repro_torch.obs import NULL_OBS, Observability
    from repro_torch.serving import pipeline as sp
    from repro_torch.serving.admission import AdmissionConfig
    from repro_torch.serving.service import EngineBackend, RetrievalService

    dev = resolve_device(args.device)
    sys_ = E.build_system(E.ExperimentConfig(
        n_docs=4000, vocab=8000, n_queries=512, stream_cap=1024,
        pool_depth=2000, gold_depth=200, query_batch=128), device=dev)
    cutoffs = sys_.k_cutoffs if args.knob == "k" else sys_.rho_cutoffs

    print(f"== labeling ({args.knob} knob, MED_RBP <= {args.tau}) ==")
    m = E.med_tables(sys_, args.knob, metrics=("rbp",))["rbp"]
    labels = labeling.envelope_labels(m, args.tau).numpy()
    print("   class histogram:", np.bincount(labels,
                                             minlength=len(cutoffs) + 1))

    print("== training the cascade ==")
    train_idx = np.arange(len(labels))
    if args.online:
        # boot era = short queries, so the --online demo's length shift
        # is genuinely out of distribution for the frozen cascade
        train_idx = np.flatnonzero(sys_.queries.lengths <= 2)
        print(f"   (boot era: {len(train_idx)} short queries)")
    casc = cascade_lib.train_cascade(
        sys_.features[train_idx], labels[train_idx],
        n_cutoffs=len(cutoffs),
        forest_kwargs=dict(n_trees=8, max_depth=6), device=dev)

    server = sp.RetrievalServer(
        sys_.index, casc, sp.ServingConfig(
            knob=args.knob, cutoffs=cutoffs, threshold=args.threshold,
            rerank_depth=100, stream_cap=sys_.cfg.stream_cap), device=dev)
    backend = EngineBackend(server,
                            query_len=sys_.queries.terms.shape[1])
    # the trace demo only pays for span recording when it will export
    obs = (Observability.create()
           if args.online and args.trace_out else NULL_OBS)
    service = RetrievalService(backend, AdmissionConfig(
        max_batch=256, default_deadline_ms=args.deadline_ms,
        pad_multiple=server.cfg.pad_multiple), obs=obs)
    service.warmup_now([256])             # deploy-time shape

    qt = sys_.queries.terms[:256]
    with service:
        service.serve_all(list(qt))       # warm the predict path
        service.reset_stats()             # report steady state only
        t0 = time.time()
        results = service.serve_all(list(qt))
        dyn_s = time.time() - t0
    out_ranked = np.stack([r["ranked"] for r in results])

    fixed = server.serve_fixed(qt, cutoffs[-1])
    t0 = time.time()
    fixed = server.serve_fixed(qt, cutoffs[-1])
    fix_s = time.time() - t0

    overlap = []
    for a, b in zip(out_ranked, fixed["ranked"]):
        sa = {d for d in a[:10] if d >= 0}
        sb = {d for d in b[:10] if d >= 0}
        if sb:
            overlap.append(len(sa & sb) / len(sb))

    stats = service.stats()
    mean_param = float(np.mean([r["width"] for r in results]))
    print(f"\n{'':<12}{'mean ' + args.knob:>12}{'q/s':>10}")
    print(f"{'dynamic':<12}{mean_param:>12.0f}{256 / dyn_s:>10.0f}")
    print(f"{'fixed max':<12}{fixed['mean_param']:>12.0f}"
          f"{256 / fix_s:>10.0f}")
    print(f"\ntop-10 agreement dynamic vs fixed-max: "
          f"{np.mean(overlap):.2%} "
          f"({len({r['class'] for r in results})} live buckets, "
          f"{stats.n_compiles} executables)")
    print("service:", stats.summary())
    print("shape census:", dict(service.queue.shape_counts),
          "| warmed:", sorted(service.warmup.compiled))

    if args.online:
        online_demo(sys_, server, service, args)


if __name__ == "__main__":
    main()
