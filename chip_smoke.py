"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--profile DIR]

Phases (any failure raises and exits non-zero; nothing is caught):

  0. the card's name and power limit; build both CUDA kernels from
     ``src/repro_torch/csrc`` (one nvcc per source, started together).
  1. each kernel against its plain torch version on the card, at the
     main path's shapes and at edge shapes, bit-equal; CUDA-event times
     of the kernel, the plain version and one library call.
  2. the main path at the repo's paper-validation scale ("paperish":
     50 000 docs, 60 000 terms, 8 000 queries, streams of 4096): build
     the system, MED tables and envelope labels, train the forest
     cascades, and serve 4 batches of 128 queries per knob through
     ``RetrievalServer(device="cuda")``, with the kernel launch counters
     zeroed just before and read just after.  The ranked lists are held
     against the per-bucket reference on the card and, for one batch,
     against the same server on the CPU.
  3. one JSON line with every kernel's launches, error and times.
  4. the last line: {"ok": true, "device": {...}}.

With ``--profile DIR``, after phase 2 each knob's server serves its
steady batches again, once on the host clock and once under
``torch.profiler``, and one ``profile:`` line per knob gives the wall ms
per batch, the device-busy ms per batch (the union of the CUDA activity
intervals), the idle share ``1 - busy / wall``, CUDA activities per
batch and the five items with the most device time; the Chrome trace of
each knob goes to ``DIR/trace_serving_<knob>.json``.

Without a CUDA card, or run outside the repository, it fails before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 ops/s
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
#: the JAX package's configs/paper_retrieval.py experiment_config("paperish")
PAPERISH = dict(n_docs=50_000, vocab=60_000, n_queries=8_000,
                stream_cap=4096, pool_depth=10_000, gold_depth=1000)
BATCH, N_BATCHES, RERANK_DEPTH, TAU = 128, 4, 100, 0.05
#: stage-2 tolerance: log/divide in float32 on two devices
STAGE2_RTOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after
    ``warm`` runs."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / FP32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------- phase 1 --

def _streams(q, p, n_docs, seed, *, pad_rows=()):
    """Impact-ordered synthetic streams: random docs, integer impacts in
    descending order, a -1 padded tail of random length per query."""
    import numpy as np
    r = np.random.default_rng(seed)
    docs = r.integers(0, n_docs, (q, p)).astype(np.int32)
    imps = -np.sort(-r.integers(0, 256, (q, p)), axis=1).astype(np.float32)
    live = r.integers(p // 4, p + 1, q)
    tail = np.arange(p)[None, :] >= live[:, None]
    docs[tail], imps[tail] = -1, -1.0
    for row in pad_rows:
        docs[row], imps[row] = -1, -1.0
    return docs, imps


def check_impact_scan(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.impact_scan import kernel as K
    from repro_torch.retrieval.index import block_doc_bounds

    max_err = 0.0

    def run(q, p, n_docs, rho, bp, bd, stats, pad_rows=()):
        nonlocal max_err
        docs, imps = _streams(q, p, n_docs, seed=q * p + n_docs,
                              pad_rows=pad_rows)
        d, i = torch.from_numpy(docs).to(dev), torch.from_numpy(imps).to(dev)
        r = torch.from_numpy(np.asarray(rho, np.int32)).to(dev)
        lo, hi = block_doc_bounds(d, block_p=bp, n_docs=n_docs)
        args = (d, i, r, lo, hi)
        kw = dict(n_docs=n_docs, block_p=bp, block_d=bd, with_stats=stats)
        got, want = K.impact_scan(*args, **kw), K.impact_scan_plain(*args, **kw)
        got, want = (got, want) if stats else ((got,), (want,))
        for g, w in zip(got, want):
            max_err = max(max_err, float((g - w).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(
                    f"impact_scan differs from its plain version at "
                    f"Q={q} P={p} n_docs={n_docs} bp={bp} bd={bd}")
        return args, kw

    q, p, n_docs = BATCH, PAPERISH["stream_cap"], PAPERISH["n_docs"]
    cuts = [max(8, int(f * p)) for f in
            (0.002, 0.004, 0.01, 0.02, 0.04, 0.1, 0.2, 0.4, 1.0)]
    rho = np.resize(cuts, q)
    main_args, main_kw = run(q, p, n_docs, rho, 512, 2048, False)
    run(q, p, n_docs, rho, 512, 2048, True)
    # edge shapes: ragged P, rho 0 and rho > P, all-padding streams,
    # doc tiles that do not divide n_docs, a doc tile above 48 KB
    run(5, 1000, 3001, [0, 1, 999, 5000, 512], 512, 2048, True,
        pad_rows=(3,))
    run(3, 65, 40, [0, 64, 65], 32, 16, True, pad_rows=(0,))
    run(2, 4096, 50_000, [4096, 300], 4096, 16384, True)
    run(1, 7, 5, [7], 512, 2048, True)

    d, i, r, lo, hi = main_args
    live = int(torch.minimum(r.long(), torch.full_like(r.long(), p)).sum())
    flat = (torch.arange(q, device=dev)[:, None] * n_docs
            + d.clamp(min=0).long()).reshape(-1)
    pos = torch.arange(p, device=dev)[None, :]
    contrib = torch.where((pos < r[:, None]) & (d >= 0), i,
                          torch.zeros_like(i)).reshape(-1)
    acc = torch.zeros(q * n_docs, device=dev)

    def library():
        acc.zero_()
        acc.scatter_add_(0, flat, contrib)

    n_p = lo.shape[1]
    n_bytes = live * 8 + q * 4 + 2 * q * n_p * 4 + q * n_docs * 4
    b_ms, b_by = bound_ms(n_bytes, live)
    return dict(
        name="impact_scan", route="cuda",
        source="src/repro_torch/csrc/impact_scan.cu",
        replaces="src/repro/kernels/impact_scan/kernel.py:158",
        max_abs_err=max_err,
        ms=time_ms(lambda: K.impact_scan(*main_args, **main_kw)),
        plain_ms=time_ms(lambda: K.impact_scan_plain(*main_args, **main_kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library),
        shape=f"Q={q} P={p} n_docs={n_docs} block_p=512 block_d=2048",
        bytes=n_bytes), K.impact_scan(*main_args, **main_kw)


def check_topk(dev, stage1_acc):
    import numpy as np
    import torch
    from repro_torch.kernels.topk import kernel as K
    from repro_torch.kernels.topk import ops

    max_err = 0.0

    def run(scores, kp, bn, vs_ref=True):
        nonlocal max_err
        gv, gi = K.block_topk(scores, kp=kp, block_n=bn)
        wv, wi = K.block_topk_plain(scores, kp=kp, block_n=bn)
        if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
            raise AssertionError(f"block_topk differs from its plain "
                                 f"version at {tuple(scores.shape)} "
                                 f"kp={kp} bn={bn}")
        fin = torch.isfinite(wv)
        if fin.any():
            max_err = max(max_err, float((gv[fin] - wv[fin]).abs().max()))
        if vs_ref:      # with at least kp finite scores a row, the
            # merged selection is the exact top-k
            sv, si = ops.topk_select(scores, kp, block_n=bn)
            rv, ri = ops.topk_select(scores, kp, use_kernel=False)
            if not (torch.equal(si, ri) and torch.equal(sv, rv)):
                raise AssertionError("topk_select differs from topk_ref")

    q, n, k = stage1_acc.shape[0], stage1_acc.shape[1], RERANK_DEPTH
    run(stage1_acc, k, 4096)                # the main path's input
    r = np.random.default_rng(4)
    ties = torch.from_numpy(np.round(r.normal(size=(9, 50_000)) * 3)
                            .astype(np.float32)).to(dev)
    for kp in (1, 128):
        run(ties, kp, 4096)
    run(ties[:, :5], 3, 2)                  # kp wider than the block
    run(ties[:2, :4999], 100, 1024)         # ragged last block
    minf = torch.full((2, 300), float("-inf"), device=dev)
    run(minf, 7, 128, vs_ref=False)         # nothing but -inf

    n_b = -(-n // 4096)
    n_bytes = q * n * 4 + q * n_b * k * 8
    b_ms, b_by = bound_ms(n_bytes, q * n)
    return dict(
        name="topk", route="cuda", source="src/repro_torch/csrc/topk.cu",
        replaces="src/repro/kernels/topk/kernel.py:94",
        max_abs_err=max_err,
        ms=time_ms(lambda: K.block_topk(stage1_acc, kp=k, block_n=4096)),
        plain_ms=time_ms(lambda: K.block_topk_plain(stage1_acc, kp=k,
                                                    block_n=4096)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.topk(stage1_acc, k, dim=1)),
        select_ms=time_ms(lambda: ops.topk_select(stage1_acc, k)),
        shape=f"Q={q} N={n} kp={k} block_n=4096", bytes=n_bytes)


# ------------------------------------------------------------- phase 2 --

def _stage2(server, qt):
    """The engine's stage-2 scores for one batch (qids = positions)."""
    import torch
    from repro_torch.retrieval import gold, jass
    eng = server.engine
    t = torch.from_numpy(qt).to(eng.device)
    sdocs, s3 = jass.gather_score_streams(eng.offsets, eng.pdoc, eng.pscore,
                                          t, cap=server.cfg.stream_cap)
    acc = jass.scorer_accumulators(sdocs, s3, eng.n_docs,
                                   n_terms=t.shape[1])
    qids = torch.arange(t.shape[0], dtype=torch.int32, device=eng.device)
    return gold.second_stage_scores(*acc, eng.doc_len, qids).cpu().numpy()


def _check_ranked(ranked, n_docs):
    import numpy as np
    if ranked.shape != (BATCH, RERANK_DEPTH):
        raise AssertionError(f"ranked shape {ranked.shape}")
    if ranked.min() < -1 or ranked.max() >= n_docs:
        raise AssertionError("ranked ids out of range")
    for row in ranked:
        docs = row[row >= 0]
        if len(np.unique(docs)) != len(docs):
            raise AssertionError("a ranked list repeats a document")
        if (row[len(docs):] != -1).any():
            raise AssertionError("-1 padding inside a ranked list")


def _compare_within_stage2(name, got, want, s2):
    """Ranked lists equal, or every differing position holds two docs
    whose stage-2 scores agree to STAGE2_RTOL."""
    import numpy as np
    qs, pos = np.nonzero(got != want)
    for q, i in zip(qs, pos):
        a, b = got[q, i], want[q, i]
        if a < 0 or b < 0:
            raise AssertionError(f"{name}: query {q} rank {i}: {a} vs {b}")
        sa, sb = s2[q, a], s2[q, b]
        if abs(sa - sb) > STAGE2_RTOL * max(abs(sa), abs(sb)):
            raise AssertionError(f"{name}: query {q} rank {i}: docs {a}/{b} "
                                 f"stage-2 {sa} vs {sb}")
    return len(qs)


def build_servers():
    """The paperish system, its MED tables and envelope labels, and one
    trained ``RetrievalServer`` per knob on the card.  Cascades train
    on every query but the last ``BATCH * N_BATCHES``, which are served.
    Returns (system, {knob: (server, cascade, config)}, batches)."""
    import numpy as np
    from repro_torch.core import cascade as cascade_lib
    from repro_torch.core import experiment as E
    from repro_torch.core import labeling
    from repro_torch.serving import pipeline

    t0 = time.perf_counter()
    cfg = E.ExperimentConfig(**PAPERISH)
    sys_ = E.build_system(cfg, device="cuda")
    log(f"phase 2: build_system paperish {PAPERISH} in "
        f"{time.perf_counter() - t0:.1f} s (nnz={sys_.index.nnz})")
    n_serve = BATCH * N_BATCHES
    n_train = cfg.n_queries - n_serve
    log(f"phase 2: cascades train on queries [0, {n_train}) and serve the "
        f"last {n_serve}")
    servers = {}
    for knob in ("rho", "k"):
        t0 = time.perf_counter()
        cuts = sys_.k_cutoffs if knob == "k" else sys_.rho_cutoffs
        med = E.med_tables(sys_, knob, metrics=("rbp",))["rbp"]
        t_med = time.perf_counter() - t0
        labels = labeling.envelope_labels(med, TAU).numpy()
        casc = cascade_lib.train_cascade(
            sys_.features[:n_train], labels[:n_train], n_cutoffs=len(cuts),
            forest_kwargs=dict(n_trees=10, max_depth=6), device="cuda")
        scfg = pipeline.ServingConfig(knob=knob, cutoffs=cuts,
                                      rerank_depth=RERANK_DEPTH,
                                      stream_cap=cfg.stream_cap)
        servers[knob] = (pipeline.RetrievalServer(sys_.index, casc, scfg,
                                                  device="cuda"), casc, scfg)
        log(f"phase 2: {knob}: med_tables {t_med:.1f} s, labels "
            f"{np.bincount(labels, minlength=10).tolist()}, cascade "
            f"{time.perf_counter() - t0 - t_med:.1f} s")
    terms = sys_.queries.terms[n_train:]
    batches = [terms[b * BATCH:(b + 1) * BATCH] for b in range(N_BATCHES)]
    return sys_, servers, batches


def main_path(sys_, servers, batches):
    import numpy as np
    from repro_torch.kernels.impact_scan import kernel as is_kernel
    from repro_torch.kernels.topk import kernel as tk_kernel
    from repro_torch.serving import pipeline

    n_docs = sys_.cfg.n_docs
    served = {}
    # ---- the counted window: nothing but the main path runs in it ----
    is_kernel.n_launches = tk_kernel.n_launches = 0
    for knob in ("rho", "k"):
        server = servers[knob][0]
        served[knob] = []
        for qt in batches:
            before = (is_kernel.n_launches, tk_kernel.n_launches)
            out = server.serve_batch(qt)
            out["launches"] = (is_kernel.n_launches - before[0],
                               tk_kernel.n_launches - before[1])
            served[knob].append(out)
    launches = {"impact_scan": is_kernel.n_launches,
                "topk": tk_kernel.n_launches}
    # ---- end of the counted window ----

    report = {}
    for knob in ("rho", "k"):
        server, casc, scfg = servers[knob]
        for b, (qt, out) in enumerate(zip(batches, served[knob])):
            n_is, n_tk = out["launches"]
            if n_is < 1 or (knob == "rho" and n_tk < 1):
                raise AssertionError(f"{knob} batch {b}: kernel launches "
                                     f"impact_scan={n_is} topk={n_tk}")
            _check_ranked(out["ranked"], n_docs)
            ref = server.serve_batch_reference(qt)
            if not np.array_equal(ref["ranked"], out["ranked"]):
                raise AssertionError(f"{knob} batch {b}: ranked differs "
                                     "from serve_batch_reference")
        cpu = pipeline.RetrievalServer(sys_.index.to("cpu"), casc.to("cpu"),
                                       scfg, device="cpu")
        qt = batches[1]
        got = served[knob][1]
        want = cpu.serve_batch(qt)
        if not np.array_equal(want["classes"], got["classes"]):
            raise AssertionError(f"{knob}: classes differ on the CPU")
        n_diff = _compare_within_stage2(f"{knob} cpu", got["ranked"],
                                        want["ranked"], _stage2(server, qt))
        steady = served[knob][1:]
        stages = {k: statistics.mean(o["timings"][k] for o in steady)
                  for k in steady[0]["timings"]}
        report[knob] = dict(
            stage_ms=stages, qps=BATCH / (stages["total_ms"] / 1e3),
            mean_param=statistics.mean(o["mean_param"] for o in steady),
            launches_per_batch=[o["launches"] for o in served[knob]],
            cpu_positions_differing=n_diff,
            cpu_stage_ms={k: v for k, v in want["timings"].items()})
        log(f"phase 2: {knob}: " + json.dumps(report[knob]))
    return launches, report


def _busy_us(events) -> float:
    """Length of the union of the events' [start, end] intervals (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile(servers, batches, trace_dir: str) -> None:
    """Device busy and idle share of each knob's steady batches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    os.makedirs(trace_dir, exist_ok=True)
    steady = batches[1:]
    for knob, (server, _, _) in servers.items():
        wall = []
        for qt in steady:
            t0 = time.perf_counter()
            server.serve_batch(qt)
            wall.append((time.perf_counter() - t0) * 1e3)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for qt in steady:
                server.serve_batch(qt)
        torch.cuda.synchronize()
        dev_events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA]
        busy_ms = _busy_us(dev_events) / 1e3 / len(steady)
        by_name = {}
        for e in dev_events:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        wall_ms = statistics.median(wall)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace_serving_{knob}.json"))
        log("profile: " + json.dumps({
            "knob": knob, "batches": len(steady),
            "wall_ms_per_batch": wall_ms,
            "device_busy_ms_per_batch": busy_ms if dev_events else None,
            "idle_share": 1 - busy_ms / wall_ms if dev_events else None,
            "cuda_activities_per_batch": len(dev_events) / len(steady),
            "top_kernels_ms_per_batch": [
                [name[:80], us / 1e3 / len(steady)] for name, us in top]}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile the served batches; traces go here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs its kernels on "
              "the card only", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name!r}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"phase 0: built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for kname, text in reports.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"phase 0: {kname}: {line.strip()}")

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    is_row, stage1_acc = check_impact_scan(dev)
    tk_row = check_topk(dev, stage1_acc)
    for row in (is_row, tk_row):
        log("phase 1: " + json.dumps(row))
    log(f"phase 1: kernels bit-equal to their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")

    sys_, servers, batches = build_servers()
    launches, _ = main_path(sys_, servers, batches)
    if args.profile:
        profile(servers, batches, args.profile)
    for row in (is_row, tk_row):
        row["launches"] = launches[row["name"]]
        for extra in ("shape", "bytes", "select_ms"):
            row.pop(extra, None)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [is_row, tk_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
