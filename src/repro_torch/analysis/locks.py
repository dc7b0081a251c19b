"""Lock-discipline checker: guarded attributes stay under their lock.
A copy of the JAX package's ``analysis/locks.py``: the port's serving
classes carry the reference's names and locks, so the registry applies
to them as it stands, with entries of the port's own at its end (the
captured program's and the program cache's locks,
``serving/programs.py``).

The serving path runs four concurrent threads (svc-admit, svc-exec,
svc-warmup, plus the online controller), coordinated by a handful of
per-object locks.  ``LOCK_REGISTRY`` below is the declarative contract:
for each class, which lock guards which attributes.  The AST pass flags
any ``self.<attr>`` read or write of a guarded attribute outside a
``with self.<lock>:`` block.

Escape hatches keep the contract honest rather than noisy:

* ``__init__`` is exempt (the object is not yet shared);
* ``assume_held`` methods are internal helpers documented as
  caller-holds-the-lock (e.g. ``AdmissionQueue._form``);
* vetted lock-free patterns are carried as baseline entries with a
  note, not silenced in code.

The runtime complement (instrumented locks + lock-order graph) lives in
``repro_torch.analysis.sanitizers``; it shares this registry so the
static and dynamic checkers can never drift apart.
"""

from __future__ import annotations

import ast
import dataclasses

from repro_torch.analysis import astutil
from repro_torch.analysis.findings import Finding

PASS_NAME = "locks"


@dataclasses.dataclass(frozen=True)
class LockSpec:
    cls: str                     # class name the contract applies to
    lock: str                    # lock attribute on self
    guarded: tuple[str, ...]     # attributes that require the lock
    assume_held: tuple[str, ...] = ()   # methods with caller-holds-lock


LOCK_REGISTRY: tuple[LockSpec, ...] = (
    # engine: AOT executable cache + compile counter
    LockSpec("ServingEngine", "_cache_lock", ("_cache", "n_compiles")),
    LockSpec("ShardedServingEngine", "_cache_lock",
             ("_cache", "n_compiles")),
    # server: live predictor tuple + its version counter
    LockSpec("RetrievalServer", "_swap_lock",
             ("_live", "predictor_version")),
    # admission: pending heap / formed batches / shape census
    LockSpec("AdmissionQueue", "_lock",
             ("_heap", "_ready", "shape_counts", "n_submitted"),
             assume_held=("_form", "_oldest")),
    # warmup policy: shape census + compile bookkeeping
    LockSpec("WarmupPolicy", "_lock",
             ("counts", "_scheduled", "compiled", "failed")),
    # service: batch records + outstanding-request count + deadline tally
    LockSpec("RetrievalService", "_lock",
             ("_records", "_outstanding", "_n_deadline_met",
              "_n_deadline_missed", "_n_cancelled")),
    # continuous scheduler: slot table, retire queue, churn counters.
    # SlotTable itself is deliberately lock-free — every access runs
    # under this lock, keeping the subsystem at one lock (its position
    # in the order: service -> admission -> sched -> swap -> cache).
    LockSpec("ContinuousScheduler", "_lock",
             ("table", "_retired", "retire_reasons", "n_admitted",
              "n_retired", "n_refill_calls", "n_chunk_calls",
              "n_finalize_calls", "n_rows_scored", "n_rows_full"),
             assume_held=("_pop_group", "_retire")),
    # online loop: telemetry ring and predictor version store
    LockSpec("TelemetryBuffer", "_lock", ("_ring", "n_seen", "n_dropped")),
    LockSpec("PredictorStore", "_lock",
             ("_versions", "_current", "_next_version")),
    # observability: span ring + metrics registry.  Both sit at the END
    # of the lock order (service -> admission -> sched -> swap -> cache
    # -> obs): leaves that acquire nothing further, so recording under
    # any serving lock is legal and the order stays acyclic.  The
    # scheduler's `_tick_id` is deliberately NOT listed here — it is
    # tick-thread-private by the single-owner contract (like `_state`).
    LockSpec("TraceRecorder", "_lock",
             ("_ring", "_head", "_open", "_tids",
              "n_begun", "n_ended", "n_dropped"),
             assume_held=("_append",)),
    LockSpec("MetricsRegistry", "_lock", ("_metrics",),
             # counters() reads each Counter's _value under this same
             # held lock (metrics share the registry lock; taking it
             # again via value() would deadlock — threading.Lock is not
             # re-entrant)
             assume_held=("counters",)),
    # the port's own, after the reference's: a captured program's lock
    # (its graph pool's, shared by the programs of one padded shape):
    # one build or call at a time from the copy-in to the copy-out (a
    # leaf but for the kernel build lock under a first launch)
    LockSpec("GraphProgram", "_lock", ("_replays", "_pool")),
    # a program cache's lock (the engine's stages and the server's
    # predicts each hold a cache): its programs and pending markers, its
    # graph pools and its build count; held briefly, never across a
    # build, below the swap lock (service -> admission -> sched -> swap
    # -> cache -> obs)
    LockSpec("ProgramCache", "_lock", ("_programs", "_pools", "n_compiles")),
)


def _is_self_attr(node: ast.AST, attr: str) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == attr
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def _with_locks(node: ast.With) -> set[str]:
    """Lock attribute names acquired by a ``with`` statement."""
    out = set()
    for item in node.items:
        d = astutil.dotted(item.context_expr)
        if d and d.startswith("self."):
            out.add(d.split(".", 1)[1])
    return out


def _check_method(method, spec: LockSpec, path: str, scope: str,
                  findings: list[Finding]) -> None:
    def visit(node: ast.AST, held: bool) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            now_held = held or spec.lock in _with_locks(node)
            for item in node.items:
                visit(item.context_expr, held)
            for child in node.body:
                visit(child, now_held)
            return
        if not held:
            for g in spec.guarded:
                if _is_self_attr(node, g):
                    action = ("write" if isinstance(
                        node.ctx, (ast.Store, ast.Del)) else "read")
                    findings.append(Finding(
                        invariant="locks/unguarded",
                        file=path, line=node.lineno, scope=scope,
                        code=f"self.{g} ({action})",
                        message=(f"`{spec.cls}.{g}` is guarded by "
                                 f"`self.{spec.lock}` but {action} "
                                 "outside a `with` block."),
                        hint=(f"wrap in `with self.{spec.lock}:` (or add "
                              "the method to the registry's assume_held "
                              "and document the caller contract)")))
                    break
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in method.body:
        visit(stmt, False)


def run(tree: ast.Module, path: str) -> list[Finding]:
    quals = astutil.qualname_map(tree)
    specs: dict[str, list[LockSpec]] = {}
    for s in LOCK_REGISTRY:
        specs.setdefault(s.cls, []).append(s)

    findings: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef) or node.name not in specs:
            continue
        for spec in specs[node.name]:
            for method in node.body:
                if not isinstance(method, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                    continue
                if method.name == "__init__":
                    continue
                if method.name in spec.assume_held:
                    continue
                _check_method(method, spec, path,
                              quals.get(method, method.name), findings)
    return findings
