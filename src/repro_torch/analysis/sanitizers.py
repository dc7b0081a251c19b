"""Opt-in runtime sanitizers of the port: the dynamic half of its
invariant analyzer.

The AST passes (``python -m repro_torch.analysis``) catch what is
visible in the source; these context managers catch what is not: a sync
that no call in the hot scope shows (``int`` of a CUDA tensor, a
data-dependent shape such as ``nonzero`` or a boolean mask, a pageable
copy deep in a helper), and a lock acquisition order that only
deadlocks under the right thread interleaving.  Nothing here is
imported by the serving modules, and nothing in them is hooked for it.

* ``no_syncs()`` -- the counterpart of the reference's
  ``no_transfers``, on the card only.  It arms
  ``torch.cuda.set_sync_debug_mode("warn")``, which warns at every call
  that waits for the device, and records each warning's innermost frame
  in the port.  Sync debug mode flags every synchronizing call, the
  vetted ones too (JAX's ``"disallow"`` lets explicit conversions
  through); so each frame is held against the vetted scopes: the lines
  of the hot-scope findings that the committed baseline allows
  (``hostsync.scan``), and the helpers in ``VETTED_HELPERS``, whose
  call sites the static pass holds.  On exit it raises ``SyncError``
  if a sync is neither vetted nor ``allowed`` (a known fault, listed in
  ROADMAP section 4).  Read ``SyncRecord.by_frame()`` for the report.
* ``compile_sentinel(*probes, allowed=0)`` -- the reference's:
  snapshots compile counters before the block and raises
  ``RecompileError`` after it if more than ``allowed`` programs were
  built.  Probes: an engine or a program cache (the server's
  ``predict_programs``; each reads ``n_compiles``, the programs its
  shape-keyed cache built) or any zero-argument callable returning an
  int.
* ``hot_path(*probes, allowed=0)`` -- the serving path's invariant in
  one guard, as the reference's (``no_transfers`` plus the sentinel):
  ``no_syncs`` plus ``compile_sentinel``.  ``no_syncs`` is armed when a
  probe is an engine or a program cache on a CUDA device; on the CPU
  there is no stream to wait for, and the sentinel is armed alone.
* ``lock_order(*objects)`` -- a copy of the reference's: wraps the
  locks the static registry (``repro_torch.analysis.locks.
  LOCK_REGISTRY``) declares on the given objects with instrumented
  proxies, builds the held->acquiring lock-order graph across all
  threads, and raises ``LockOrderError`` on exit if the graph has a
  cycle.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import dataclasses
import os
import sys
import threading
import warnings

import torch

from repro_torch.analysis import DEFAULT_BASELINE, hostsync
from repro_torch.analysis.findings import load_baseline
from repro_torch.analysis.locks import LOCK_REGISTRY

__all__ = ["SyncError", "RecompileError", "LockOrderError", "Sync",
           "SyncRecord", "CompileRecord", "VETTED_HELPERS", "vetted_lines",
           "no_syncs", "compile_sentinel", "hot_path", "lock_order",
           "LockOrderGraph", "InstrumentedLock"]

#: the package directory: a frame under it is the port's
PORT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: what ``c10::cuda::warn_or_error_on_sync`` warns
_SYNC_MESSAGE = "called a synchronizing CUDA operation"

#: (file in the package, scope) -> why a sync there is vetted wherever
#: it is called from
VETTED_HELPERS = {
    ("device.py", "fence"): (
        "the timing fence: waits for the calling thread's stream; each "
        "call site in a hot scope is a hostsync/blocking-sync finding the "
        "baseline vets (the engine's per-stage spans)"),
}


class SyncError(AssertionError):
    """A guarded block waited for the device at a frame that is neither
    vetted nor allowed."""


class RecompileError(AssertionError):
    """A guarded block built more programs than allowed."""


class LockOrderError(AssertionError):
    """Instrumented locks were acquired in cyclically inconsistent
    order (deadlock potential)."""


# -------------------------------------------------------------- syncs --

@dataclasses.dataclass(frozen=True)
class Sync:
    file: str          # posix path in the package (``serving/engine.py``)
    line: int
    scope: str         # dotted qualname, as the static pass names scopes
    status: str        # "vetted", "allowed" or "unvetted"

    @property
    def frame(self) -> str:
        return f"{self.file}:{self.line} {self.scope}"


class SyncRecord:
    """The syncs a ``no_syncs`` block saw, in order."""

    def __init__(self):
        self.syncs: list[Sync] = []

    def by_frame(self) -> dict[str, dict]:
        """{frame: {"count", "status"}} in order of first sight."""
        counts = collections.Counter(s.frame for s in self.syncs)
        status = {s.frame: s.status for s in self.syncs}
        return {f: {"count": counts[f], "status": status[f]}
                for f in dict.fromkeys(s.frame for s in self.syncs)}

    def unvetted(self) -> list[Sync]:
        return [s for s in self.syncs if s.status == "unvetted"]


def _package_path(path: str) -> str | None:
    """``path`` relative to the package (posix), or None outside it."""
    p = os.path.abspath(path)
    if not p.startswith(PORT_ROOT + os.sep):
        return None
    return os.path.relpath(p, PORT_ROOT).replace(os.sep, "/")


def vetted_lines(baseline: str = DEFAULT_BASELINE) -> dict:
    """{(file in the package, scope): [(first line, last line)]} of the
    hot-scope findings the baseline allows, found by running the static
    pass over the files it names (as they are now)."""
    allowed, _ = load_baseline(baseline)
    keys = {k for k in allowed if k[0].startswith(hostsync.PASS_NAME + "/")}
    out: dict = collections.defaultdict(list)
    for name in sorted({k[1] for k in keys}):
        rel = name.split("repro_torch/", 1)[-1]
        with open(os.path.join(PORT_ROOT, rel), encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=name)
        for finding, end in hostsync.scan(tree, name):
            if finding.key() in keys:
                out[(rel, finding.scope)].append((finding.line, end))
    return dict(out)


def _port_frame(frame):
    """The innermost frame of the port outside this module."""
    here = os.path.abspath(__file__)
    while frame is not None:
        fn = frame.f_code.co_filename
        if os.path.abspath(fn) != here:
            rel = _package_path(fn)
            if rel is not None:
                return rel, frame.f_lineno, frame.f_code.co_qualname.replace(
                    ".<locals>", "")
        frame = frame.f_back
    return "<outside the port>", 0, ""


def _status(rel, line, scope, vetted, allowed) -> str:
    if (rel, scope) in VETTED_HELPERS or any(
            lo <= line <= hi for lo, hi in vetted.get((rel, scope), ())):
        return "vetted"
    if (rel, scope) in allowed:
        return "allowed"
    return "unvetted"


@contextlib.contextmanager
def no_syncs(*, allowed=(), baseline: str = DEFAULT_BASELINE):
    """Record every call in the block that waits for the device, each at
    its innermost frame in the port, and raise ``SyncError`` on exit if
    one is neither vetted nor in ``allowed`` ((file in the package,
    scope) pairs: known faults).  Yields the ``SyncRecord``; exceptions
    of the block propagate unchecked.  The card only: sync debug mode
    watches CUDA calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("no_syncs needs a CUDA card: torch's sync debug "
                           "mode watches the calls that wait for it")
    vetted = vetted_lines(baseline)
    allowed = set(allowed)
    rec = SyncRecord()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        passthrough = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if _SYNC_MESSAGE not in str(message):
                passthrough(message, category, filename, lineno, file, line)
                return
            rel, ln, scope = _port_frame(sys._getframe(1))
            rec.syncs.append(Sync(rel, ln, scope,
                                  _status(rel, ln, scope, vetted, allowed)))

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield rec
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    bad = rec.unvetted()
    if bad:
        frames = sorted({s.frame for s in bad})
        raise SyncError(f"{len(bad)} unvetted sync(s) at " + "; ".join(frames)
                        + ": keep the stage on the device, or vet the call "
                        "in the baseline with a note")


# ----------------------------------------------------- compile sentinel --

def _as_probe(p):
    """A probe as a zero-argument callable returning an int."""
    if hasattr(p, "n_compiles"):
        return lambda: p.n_compiles
    if callable(p):
        return p
    raise TypeError(f"compile sentinel probe {p!r} is neither an engine "
                    "(n_compiles) nor a callable")


class CompileRecord:
    """Filled in when the sentinel block exits (``syncs``: the
    ``no_syncs`` record of a ``hot_path`` on the card, else None)."""

    def __init__(self):
        self.new_compiles = None
        self.syncs: SyncRecord | None = None


@contextlib.contextmanager
def compile_sentinel(*probes, allowed: int = 0):
    """Raise ``RecompileError`` if more than ``allowed`` new programs
    are built across the block, summed over all probes."""
    fns = [_as_probe(p) for p in probes]
    if not fns:
        raise TypeError("compile_sentinel needs at least one probe")
    start = [f() for f in fns]
    rec = CompileRecord()
    yield rec                      # body exceptions propagate unchecked
    rec.new_compiles = sum(f() - s for f, s in zip(fns, start))
    if rec.new_compiles > allowed:
        raise RecompileError(
            f"{rec.new_compiles} new program(s) built inside a "
            f"compile_sentinel block (allowed {allowed}): a shape off the "
            "pad grid, or a static keyword that varies, defeated the "
            "program cache")


def _on_card(probes) -> bool:
    return any(getattr(getattr(p, "device", None), "type", None) == "cuda"
               for p in probes)


@contextlib.contextmanager
def hot_path(*probes, allowed: int = 0, allowed_syncs=(),
             baseline: str = DEFAULT_BASELINE):
    """The serving-path invariant in one guard: no unvetted sync (on the
    card: ``no_syncs`` with ``allowed_syncs``) and at most ``allowed``
    new programs.  On the CPU there is no stream to sync with, and only
    the sentinel is armed."""
    with contextlib.ExitStack() as stack:
        syncs = (stack.enter_context(no_syncs(allowed=allowed_syncs,
                                              baseline=baseline))
                 if _on_card(probes) else None)
        rec = stack.enter_context(compile_sentinel(*probes,
                                                   allowed=allowed))
        rec.syncs = syncs
        yield rec


# --------------------------------------------------------- lock order --

class LockOrderGraph:
    """held-lock → acquiring-lock edges, accumulated across threads."""

    def __init__(self):
        self._edges: dict[str, set[str]] = {}
        self._mu = threading.Lock()
        self._tls = threading.local()

    def _held(self) -> list[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def note_acquire(self, name: str) -> None:
        held = self._held()
        with self._mu:
            for h in held:
                if h != name:
                    self._edges.setdefault(h, set()).add(name)
        held.append(name)

    def note_release(self, name: str) -> None:
        held = self._held()
        if name in held:
            held.reverse()
            held.remove(name)      # drop the most recent acquisition
            held.reverse()

    def cycles(self) -> list[list[str]]:
        """All distinct lock-order cycles (each as a closed name path)."""
        out, seen = [], set()

        def dfs(node, path, on_path):
            for nxt in sorted(self._edges.get(node, ())):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    lo = min(range(len(cyc) - 1),
                             key=lambda i: cyc[i])       # canonical form
                    canon = tuple(cyc[lo:-1] + cyc[:lo])
                    if canon not in seen:
                        seen.add(canon)
                        out.append(cyc)
                    continue
                dfs(nxt, path + [nxt], on_path | {nxt})

        for start in sorted(self._edges):
            dfs(start, [start], {start})
        return out

    def check(self) -> None:
        cyc = self.cycles()
        if cyc:
            lines = " ; ".join(" -> ".join(c) for c in cyc)
            raise LockOrderError(
                f"inconsistent lock acquisition order (deadlock "
                f"potential): {lines}. Fix the ordering or release the "
                "outer lock before taking the inner one.")


class InstrumentedLock:
    """Drop-in lock proxy that reports acquisitions to a graph."""

    def __init__(self, inner, name: str, graph: LockOrderGraph):
        self._inner = inner
        self._name = name
        self._graph = graph

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._graph.note_acquire(self._name)
        return ok

    def release(self) -> None:
        self._graph.note_release(self._name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _registry_lock_attrs(obj) -> list[str]:
    attrs = []
    for klass in type(obj).__mro__:
        for spec in LOCK_REGISTRY:
            if spec.cls == klass.__name__ and spec.lock not in attrs:
                attrs.append(spec.lock)
    return attrs


@contextlib.contextmanager
def lock_order(*objects, extra=(), graph: LockOrderGraph | None = None):
    """Instrument the registry-declared locks of ``objects`` (plus any
    explicit ``(obj, attr_name)`` pairs in ``extra``) for the duration
    of the block; raise ``LockOrderError`` on exit if the observed
    acquisition graph has a cycle.

    Instrument *before* starting the threads that use the locks — the
    attribute swap itself is not atomic with respect to a concurrent
    ``with obj._lock`` entry.
    """
    graph = graph or LockOrderGraph()
    targets: list[tuple[object, str]] = []
    for obj in objects:
        attrs = _registry_lock_attrs(obj)
        if not attrs:
            raise TypeError(
                f"{type(obj).__name__} has no locks in "
                "repro_torch.analysis.locks.LOCK_REGISTRY; pass it via "
                "extra=[(obj, '_lock')]")
        targets.extend((obj, a) for a in attrs)
    targets.extend(tuple(e) for e in extra)

    patched: list[tuple[object, str, object]] = []
    used: dict[str, int] = {}
    try:
        for obj, attr in targets:
            inner = getattr(obj, attr)
            name = f"{type(obj).__name__}.{attr}"
            used[name] = used.get(name, 0) + 1
            if used[name] > 1:     # two instances of the same class:
                name += f"#{used[name]}"   # distinct graph nodes
            setattr(obj, attr, InstrumentedLock(inner, name, graph))
            patched.append((obj, attr, inner))
        yield graph
    finally:
        for obj, attr, inner in patched:
            setattr(obj, attr, inner)
    graph.check()
