"""One run of one cell: set-up, the measured window, the check of what
the window served, the metrics, and the result line.

Set-up makes every input from the seed (the corpus, the query log split
into a training and a served slice, and the cascade fitted on envelope
labels that the reference works out over the training slice), builds
the port's index, server and service, warms every padded batch size of
the admission grid, and runs ``warm_s`` of the cell's own traffic.  The
window then runs ``--seconds`` of that traffic; nothing is built in it.
After it closes, memory is read, the port is freed, and the reference
judges a sample of the requests the window served.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check as check_lib
from portbench import devtrace
from portbench.gcwatch import GCWatch
from portbench import traffic as traffic_lib
from portbench.reference import corpus as ref_corpus
from portbench.reference import features as ref_feat
from portbench.reference import forest as ref_forest
from portbench.reference import index as ref_index
from portbench.reference import retrieval as ref_ret

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: bound of the traced run's span recorder (a few spans a batch): far
#: above what a window records, so that no span is dropped
SPAN_CAPACITY = 50_000_000


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_spec(cell: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic mix and metric entries,
    found by name from ``BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"unknown workload {cell!r}: {sorted(cells)}")
    w = cells[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "workloads" / f"{w['traffic']}.json")
        .read_text())
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return dict(cell=w, config=config, traffic=traffic, end_to_end=e2e,
                per_layer=layer, root=root)


def reader(root: Path, name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def seed_streams(seed: int) -> dict:
    """Independent streams of one seed: corpus, queries, forest fit,
    traffic, and the sample the check judges."""
    kids = np.random.SeedSequence(int(seed) % 2 ** 64).spawn(5)
    return dict(corpus=kids[0], queries=kids[1],
                forest=int(kids[2].generate_state(1)[0]),
                traffic=np.random.default_rng(kids[3]),
                sample=np.random.default_rng(kids[4]))


@dataclasses.dataclass
class Inputs:
    corpus: ref_corpus.Corpus
    index: ref_index.Index
    train: np.ndarray        # (n_train, query_len) query terms
    served: np.ndarray       # (n_served, query_len) query terms
    labels: np.ndarray       # (n_train,) envelope classes
    cascade: list            # per node its forest tables


def make_inputs(cfg: dict, sd: dict, device, times: dict) -> Inputs:
    t = time.perf_counter()
    corpus = ref_corpus.make_corpus(cfg["n_docs"], cfg["vocab"],
                                    seed=sd["corpus"], **cfg["corpus"])
    terms = ref_corpus.make_queries(corpus, cfg["n_queries"],
                                    max_len=cfg["query_len"],
                                    seed=sd["queries"])
    index = ref_index.build_index(corpus)
    times["corpus_index_s"] = time.perf_counter() - t
    t = time.perf_counter()
    n = cfg["train_queries"]
    ix = index.tensors(device)
    labels = ref_ret.envelope_labels(
        ix, terms[:n], knob=cfg["knob"], cutoffs=cfg["cutoffs"],
        cap=cfg["stream_cap"], pool_depth=cfg["pool_depth"],
        gold_depth=cfg["gold_depth"], tau=cfg["tau"], rbp_p=cfg["rbp_p"])
    x = ref_feat.features(torch.from_numpy(terms[:n]).to(device),
                          ix["stats"], ix["ctf"], ix["df"]).cpu().numpy()
    del ix
    times["labels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cascade = ref_forest.fit_cascade(x, labels, n_cutoffs=len(cfg["cutoffs"]),
                                     seed=sd["forest"], **cfg["forest"])
    times["fit_s"] = time.perf_counter() - t
    return Inputs(corpus, index, terms[:n], terms[n:], labels, cascade)


@dataclasses.dataclass
class RunData:
    """What a metric reader reads (``metrics/<name>.py``)."""

    config: dict
    traffic: dict
    seconds: float
    t0: float                # window bounds, perf_counter seconds
    t1: float
    due: np.ndarray          # per request of the window
    done: np.ndarray         # completion stamp, NaN if not done
    failed: np.ndarray       # raised, cancelled or not done at the close
    t_close: float           # when the harness stopped waiting
    batch_of: np.ndarray | None   # per request its batch (traced runs)
    batches: dict            # port.batch_table
    spans: list              # the service's spans in the window (traced)
    trace: devtrace.Trace | None
    setup_s: float
    mem_reserved: int


def _longest(idx: np.ndarray, n_terms: np.ndarray, n: int, rng):
    """The ``n`` of ``idx`` with the most query terms (ties in a seeded
    order): the requests with the longest posting streams."""
    order = rng.permutation(len(idx))
    return idx[order[np.argsort(-n_terms[order], kind="stable")[:n]]]


def _keep(traffic: dict, seconds: float, n_terms: np.ndarray, rng):
    """Which requests' results the loop keeps for the check: in an open
    loop twice the sample, drawn from the window's schedule, and the
    longest queries; in a closed loop a share of every chunk."""
    n_check = int(traffic["check_sample"])
    n_long = int(traffic.get("check_longest", 0))
    if traffic["loop"] == "open":
        def keep(offsets, rows):
            win = np.flatnonzero((offsets >= 0) & (offsets < seconds))
            mask = np.zeros(offsets.shape[0], bool)
            mask[rng.permutation(win)[:2 * n_check]] = True
            mask[_longest(win, n_terms[rows[win]], n_long, rng)] = True
            return mask
        return keep

    def keep_chunk(c):
        return rng.random(traffic_lib.CHUNK) < float(traffic["check_share"])
    return keep_chunk


def _sample(kept: dict, done_ok: np.ndarray, n_terms_of: np.ndarray,
            traffic: dict, rng) -> np.ndarray:
    """The requests the reference judges: of the kept results of requests
    due in the window and served, ``check_sample`` drawn from the seed
    and the ``check_longest`` longest queries."""
    ok = set(done_ok.tolist())
    eligible = np.array(sorted(i for i in kept if i in ok), np.int64)
    top = _longest(eligible, n_terms_of[eligible],
                   int(traffic.get("check_longest", 0)), rng)
    rest = np.setdiff1d(eligible, top)
    return np.concatenate(
        [rng.permutation(rest)[:int(traffic["check_sample"])], top])


def run(spec: dict, seed: int, seconds: float, trace: bool, device,
        t_begin: float, control: bool = False) -> tuple[dict, list]:
    """One run; returns (result line, [(check name, value, limit)]).
    ``control`` also judges the lower-precision control on the same
    sample (``out["control"]``); the benchmark's own runs never do."""
    cfg, traffic = spec["config"], spec["traffic"]
    sd = seed_streams(seed)
    times: dict = {}
    inputs = make_inputs(cfg, sd, device, times)
    # objects the collector tracks once the harness holds its inputs,
    # once the port is built, and after the window: what a full
    # collection walks, and whose
    times["tracked_inputs"] = len(gc.get_objects())
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    from portbench import port
    obs = None
    if trace:
        from repro_torch.obs import MetricsRegistry, Observability
        obs = Observability(trace=port.BatchTrace(capacity=SPAN_CAPACITY),
                            metrics=MetricsRegistry())
        devtrace.warm(device)
    t = time.perf_counter()
    server, backend, service = port.build(inputs, cfg, traffic, device,
                                          obs=obs)
    times["port_s"] = time.perf_counter() - t
    built0 = port.programs_built(server)
    payloads = list(inputs.served)
    warm_s = float(traffic["warm_s"])
    # every run enters its traffic with the collector in the same state:
    # what set-up left is collected, so the collections that the window
    # pays for fall at the same points of every run's request stream
    t = time.perf_counter()
    gc.collect()
    times["collect_s"] = time.perf_counter() - t
    times["tracked_start"] = len(gc.get_objects())
    service.start()
    t_start = time.perf_counter() + 0.01
    slicer = None
    if trace:
        # the window's last profile_s
        length = min(float(traffic["profile_s"]), seconds)
        slicer = devtrace.SliceThread(
            device, t_start + warm_s + seconds - length, length)
        slicer.start()
    loop = traffic_lib.LOOPS[traffic["loop"]]
    n_terms = (inputs.served >= 0).sum(axis=1)
    keep = _keep(traffic, seconds, n_terms, sd["sample"])
    with GCWatch() as gcw:
        reqs, t0, t1 = loop(service, payloads, traffic, t_start, warm_s,
                            seconds, sd["traffic"], keep=keep)
    setup_s = t0 - t_begin
    a = reqs.arrays()
    if traffic["loop"] == "open":
        win = np.flatnonzero((a["due"] >= t0) & (a["due"] < t1))
    else:   # sent in the window, or still in flight when it opened
        win = np.flatnonzero(((a["sent"] >= t0) & (a["sent"] < t1))
                             | ((a["sent"] < t0) & ~(a["done"] < t0)))
    t_close = max(t1, time.perf_counter()) + float(traffic["drain_s"])
    while (time.perf_counter() < t_close
           and np.isnan(reqs.column("done")[win]).any()):
        time.sleep(0.005)
    a = reqs.arrays()
    failed = a["failed"][win] | np.isnan(a["done"][win])
    done = np.where(failed, np.nan, a["done"][win])
    mem = torch.cuda.max_memory_reserved(device) if cuda else 0
    drained = service.drain(timeout=60.0)
    service.stop(drain=drained)
    times["tracked_end"] = len(gc.get_objects())
    if slicer is not None:
        slicer.release.set()
        slicer.join(timeout=300.0)
    built = port.programs_built(server) - built0
    late = ((a["sent"] - a["due"])[win] * 1e3
            if traffic["loop"] == "open" else None)

    # ---- the window is closed: the sample the reference judges ----
    pick = _sample(reqs.kept, win[~failed], n_terms[a["row"]], traffic,
                   sd["sample"])
    res = [reqs.kept[int(i)] for i in pick]
    s_terms = inputs.served[a["row"][pick]]
    s_qids = np.array([r["row"] for r in res], np.int64)
    s_cls = np.array([r["class"] for r in res], np.int64)
    s_lists = np.stack([np.asarray(r["ranked"], np.int64) for r in res])
    stream_len = inputs.index.stream_len
    if cfg["knob"] == "rho":
        def widths_of(c):
            return check_lib.widths(cfg, c)
    else:
        def widths_of(c):
            return np.full(len(c), cfg["stream_cap"], np.int64)
    batches = port.batch_table(backend, widths_of, stream_len,
                               cfg["stream_cap"])
    batch_of = None
    spans, dev_trace = [], None
    if trace:
        batch_of = a["batch"][win]
        spans = [h for h in obs.trace.spans() if t0 <= h.t0 < t1]
        counts = obs.trace.counts()
        log(f"portbench: spans held {counts['n_held']}, dropped "
            f"{counts['n_dropped']}")
        if slicer.error is not None:
            log(f"portbench: profiler slice failed: {slicer.error!r}")
        elif slicer.prof is not None:
            dev_trace = devtrace.reduce(slicer, backend.predicts,
                                        backend.executes)
        if dev_trace is not None:
            for part in ("impact_scan_kernel", "block_topk_kernel"):
                calls = dev_trace.kernels(part)
                log(f"portbench: traced {part}: {len(calls)} calls, "
                    f"{sum(b >= 0 for _, b in calls)} tied to a batch")
        del slicer
    n_batches = int(np.sum((batches["exec_t0"] >= t0)
                           & (batches["exec_t0"] < t1)))
    del service, backend, server, reqs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the reference judges the sample ----
    t = time.perf_counter()
    ix = inputs.index.tensors(device)
    numbers = check_lib.judge(ix, inputs.cascade, cfg, s_terms, s_qids,
                              s_cls, s_lists)
    low = (check_lib.judge(ix, inputs.cascade, cfg, s_terms, s_qids,
                           control=True) if control else None)
    del ix
    times["check_s"] = time.perf_counter() - t
    limits = cfg["limits"]
    correct = check_lib.verdict(numbers, limits)

    data = RunData(config=cfg, traffic=traffic, seconds=seconds, t0=t0,
                   t1=t1, due=a["due"][win], done=done, failed=failed,
                   t_close=t_close, batch_of=batch_of, batches=batches,
                   spans=spans, trace=dev_trace, setup_s=setup_s,
                   mem_reserved=mem)
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in entries:
        value = reader(spec["root"], m["name"])(data)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(mem)}
    out = {"correct": bool(correct), "attempted": int(len(win)),
           "failed": int(failed.sum()), "metrics": metrics,
           "device": device_info}
    if trace and dev_trace is not None:
        device_info["busy_s"] = dev_trace.busy_s
        device_info["window_s"] = dev_trace.window_s
        out["breakdown"] = {"device_ops": dev_trace.top_ops(),
                            "idle_gaps": dev_trace.idle_gaps()}

    classes = np.bincount(inputs.labels, minlength=len(cfg["cutoffs"]) + 1)
    log(f"portbench: setup {json.dumps({k: round(v, 3) for k, v in times.items()})}"
        f" setup_s {setup_s:.3f}; training labels {classes.tolist()}")
    log(f"portbench: programs built in the window: {built}")
    log(f"portbench: window {seconds} s, requests {len(win)}, failed "
        f"{int(failed.sum())}, batches {n_batches}, sample {len(pick)}")
    log(f"portbench: collector in the window {json.dumps(gcw.summary(t0, t1))}")
    if late is not None and len(late):
        log(f"portbench: generator lateness ms p50 "
            f"{np.percentile(late, 50):.4f} p99 {np.percentile(late, 99):.4f}"
            f" max {late.max():.4f}")
    if low is not None:
        out["control"] = low
    checks = [(k, numbers[k], limits[k]) for k in check_lib.NAMES]
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return out, checks


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
