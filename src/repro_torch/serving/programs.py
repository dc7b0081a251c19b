"""The program caches of the port: one program per stage and input shapes.

The port of what the JAX package's compiled executables are to its
serving path: the engine's AOT cache (``ServingEngine._compiled``), the
server's jitted predicts (``RetrievalServer._predict_fns``) and the LM
decode bundle's jitted ``serve_step`` (``serving/decode.py``).  A
``ProgramCache`` holds the programs of one owner -- the engine's stages,
the server's predict and margin, or one parameter tree's decode steps
-- each at one key: the stage's name and its tensor arguments' shapes
and dtypes, with its static configuration bound by keyword.  Each
owner holds a cache of its own, so each counts its own builds
(``n_compiles``), and on a card each has its own graph pools: a
predict on the service's admission stream never waits for a pool lock
that an engine stage on the execution thread holds.

* ``EagerProgram`` (the CPU): the stage function itself.  Nothing is
  captured; the cache's keys, counts, locks and warmup are the same.
* ``GraphProgram`` (a CUDA device): the stage captured once as a
  ``torch.cuda.CUDAGraph`` and replayed after that.

A ``GraphProgram`` is built in four steps, all on the building
thread's side stream (``side``, one a thread, so the eager runs of its
builds share one stream's cached blocks), which first waits for the
caller's stream: the tensor arguments are cloned into static inputs
(the engine's constants, its index tensors, are used in place:
``consts``); the stage runs once eagerly (first-use ``nvcc`` builds,
library handles, allocator warm-up); it is captured into its
``GraphPool``'s memory pool with ``capture_error_mode="thread_local"``,
so a capture on the service's warmup thread does not forbid the
execution thread's calls beside it; then the caller's stream waits for
the side stream.  ``torch.cuda.graph`` is not used: it synchronizes the
whole device on entry, which would wait for the admission thread's
predict stream.  The build's kernel launches count nothing; the
capture's are tallied and counted at each replay (``kernels/_build.py``).

A call copies its arguments into the static inputs, replays, and returns
clones of the static outputs: nothing handed back is storage that a
later replay writes, so a ``SchedState`` stays a value and a warmup
mid-flight cannot touch live rows.  The programs of one padded shape
(of a whole cache built with ``one_pool``, the funnel's) share a
``GraphPool``: one memory pool (a later capture reuses what an
earlier one freed, its intermediates; the outputs stay held), one lock
and one last-use event.  ``_lock`` (the pool's) covers a build, and a
call from the copy-in to the copy-out, and a call's stream first waits
for the pool's previous copy-out (``GraphPool.done``), so no two
programs of a pool run at once, from any thread or stream.

A failed build or replay raises; nothing runs the stage eagerly in its
place.
"""

from __future__ import annotations

import functools
import threading

import torch

from repro_torch import obs as obs_lib
from repro_torch.kernels import _build

__all__ = ["EagerProgram", "GraphPool", "GraphProgram", "ProgramCache",
           "build_program"]


def _tensors(out, name: str) -> tuple[torch.Tensor, ...]:
    """A stage's result as a tuple of tensors (a stage returns a tensor
    or a tuple of them)."""
    outs = out if isinstance(out, tuple) else (out,)
    if not all(isinstance(t, torch.Tensor) for t in outs):
        raise TypeError(f"stage {name!r} must return a tensor or a tuple "
                        "of tensors to be captured")
    return outs


class EagerProgram:
    """The stage function with its static keywords bound (the CPU)."""

    graph = False

    def __init__(self, name: str, fn, kwargs: dict):
        self.name = name
        self.kwargs = kwargs
        self._fn = functools.partial(fn, **kwargs)

    def __call__(self, *args):
        return self._fn(*args)

    def stats(self) -> dict:
        return {"replays": 0, "static_bytes": 0}


class GraphPool:
    """What the programs of one padded shape share: a CUDA graph memory
    pool, the lock that lets one of them build or run at a time, and the
    event of the last call's copy-out."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()


class GraphProgram:
    """One stage at one key, captured as a CUDA graph and replayed."""

    graph = True

    def __init__(self, name: str, fn, args, kwargs: dict,
                 device: torch.device, pool: GraphPool,
                 side: torch.cuda.Stream, consts=()):
        self.name = name
        self.kwargs = kwargs
        self.device = device
        self._pool = pool
        self._lock = pool.lock
        self._replays = 0
        const_ids = {id(t) for t in consts}
        caller = torch.cuda.current_stream(device)
        with self._lock:
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                self._inputs = tuple(
                    a if id(a) in const_ids
                    else a.clone(memory_format=torch.contiguous_format)
                    for a in args)
                self._fixed = tuple(id(a) in const_ids for a in args)
                # the build's own runs count no launch: the eager run's
                # tally is dropped, the capture's kept for the replays
                with _build.capture_tally():
                    fn(*self._inputs, **kwargs)
                graph = torch.cuda.CUDAGraph()
                with _build.capture_tally() as tally:
                    graph.capture_begin(pool=pool.handle,
                                        capture_error_mode="thread_local")
                    try:
                        out = fn(*self._inputs, **kwargs)
                    except BaseException:
                        try:
                            graph.capture_end()
                        except RuntimeError:
                            # the capture was invalidated, and ending it
                            # raised before the caching allocator let go
                            # of the pool, which stays marked as recording:
                            # this shape's later captures take a new one
                            pool.handle = torch.cuda.graph_pool_handle()
                        raise   # the stage's own error is the one raised
                    graph.capture_end()
            caller.wait_stream(side)
            pool.done.record(caller)
        self._graph = graph
        self._single = not isinstance(out, tuple)
        self._outputs = _tensors(out, name)
        self._tally = dict(tally)

    def __call__(self, *args):
        if len(args) != len(self._inputs):
            raise TypeError(f"program {self.name!r} takes "
                            f"{len(self._inputs)} tensors, got {len(args)}")
        stream = torch.cuda.current_stream(self.device)
        with self._lock:
            stream.wait_event(self._pool.done)
            for a, s, fixed in zip(args, self._inputs, self._fixed):
                if a is s:
                    continue
                if fixed:
                    raise ValueError(
                        f"program {self.name!r}: an argument captured as "
                        "an engine constant is not the same tensor")
                if a.device != s.device:
                    raise ValueError(
                        f"program {self.name!r}: argument on {a.device}, "
                        f"captured on {s.device}")
                s.copy_(a)
            self._graph.replay()
            outs = tuple(o.clone() for o in self._outputs)
            self._pool.done.record(stream)
            self._replays += 1
        _build.count_replay(self._tally)
        return outs[0] if self._single else outs

    def stats(self) -> dict:
        """Replays so far, and the bytes of the static inputs (constants
        left out) and outputs the program holds."""
        held = [s for s, fixed in zip(self._inputs, self._fixed)
                if not fixed] + list(self._outputs)
        with self._lock:
            replays = self._replays
        return {"replays": replays,
                "static_bytes": sum(t.numel() * t.element_size()
                                    for t in held)}


def build_program(name: str, fn, args, kwargs: dict, device: torch.device,
                  pool: GraphPool | None = None, side=None, consts=()):
    """The program of one cache key: a graph captured into ``pool`` on
    the ``side`` stream on a CUDA device, the stage function itself on
    the CPU."""
    if device.type == "cuda":
        return GraphProgram(name, fn, args, kwargs, device, pool, side,
                            consts)
    if device.type != "cpu":
        raise ValueError(f"the program cache runs on cuda or cpu, not "
                         f"{device}")
    return EagerProgram(name, fn, kwargs)


class _PendingCompile:
    """In-flight marker in a program cache (see ``ProgramCache.compiled``)."""

    def __init__(self):
        self.ready = threading.Event()
        self.exe = None
        self.err: BaseException | None = None


class ProgramCache:
    """Shape-keyed programs of one owner on one device.

    ``compiled(name, fn, args, kwargs)`` returns the program of the key
    ``(name,) + ((shape, dtype) of each argument)``, building it on a
    miss, as the JAX engine's ``_compiled`` does; every positional
    argument is a tensor and static configuration goes by keyword (fixed
    for a name: a hit with other keywords raises).  ``consts`` are the
    owner's tensors a captured program reads in place (the engine's
    index, the server's term statistics, a model's parameters); a build
    may add its own (a decode program's cache).

    Thread-safe: the service's warmup thread builds beside the serving
    threads, so a miss installs a pending marker under ``_lock`` and
    exactly one thread builds each key (others wait on its event instead
    of building it again or counting it twice in ``n_compiles``).  On a
    card a program is captured into the ``GraphPool`` of its padded
    batch size (the leading size of its first argument that is not a
    constant) on the building thread's side stream (one a thread and
    cache).  ``one_pool``: every program of the cache shares one
    ``GraphPool`` whatever its padded size, so the cache holds the
    intermediates of its largest program once, not once a padded size.
    ``metric`` (a counter, ``obs``) counts each build."""

    def __init__(self, device: torch.device, consts=(),
                 one_pool: bool = False):
        self.device = device
        self.consts = tuple(consts)
        self.one_pool = one_pool
        self._lock = threading.Lock()
        self._programs: dict = {}        # key -> program or _PendingCompile
        self._pools: dict = {}           # padded batch -> GraphPool (card)
        self._sides = threading.local()  # each thread's build stream
        self.n_compiles = 0
        self.metric = obs_lib.NULL_METRIC

    def compiled(self, name: str, fn, args, kwargs: dict, consts=()):
        """The program of ``name`` at ``args``' shapes; built on a miss.
        ``consts``: tensors among ``args`` that this program alone reads
        in place besides the cache's own (a decode program's KV cache);
        a later call must hand it the same tensors."""
        if not args or not all(isinstance(a, torch.Tensor) for a in args):
            raise TypeError(
                f"stage {name!r}: the program cache keys on tensor "
                "arguments only (static configuration goes by keyword), "
                f"got {[type(a).__name__ for a in args]}")
        key = (name,) + tuple((tuple(a.shape), a.dtype) for a in args)
        owner = False
        with self._lock:
            entry = self._programs.get(key)
            if entry is None:
                entry = self._programs[key] = _PendingCompile()
                owner = True
        if isinstance(entry, _PendingCompile):
            if owner:
                fixed = self.consts + tuple(consts)
                try:
                    exe = build_program(name, fn, args, kwargs, self.device,
                                        *self._place(args, fixed),
                                        consts=fixed)
                except BaseException as e:
                    with self._lock:
                        self._programs.pop(key, None)
                    entry.err = e
                    entry.ready.set()
                    raise
                with self._lock:
                    self._programs[key] = exe
                    self.n_compiles += 1
                self.metric.inc()
                entry.exe = exe
                entry.ready.set()
                return exe
            entry.ready.wait()
            if entry.err is not None:
                raise entry.err
            entry = entry.exe
        if entry.kwargs != kwargs:
            raise ValueError(
                f"stage {name!r} was built with {entry.kwargs} and is "
                f"called with {kwargs}: static keywords are part of the "
                "stage's name")
        return entry

    def _place(self, args, consts) -> tuple:
        """(pool, side stream) of a program built on a card: the pool of
        its padded batch size, and the building thread's side stream;
        (None, None) on the CPU."""
        if self.device.type != "cuda":
            return None, None
        b = None if self.one_pool else next(
            (a.shape[0] for a in args if not any(a is c for c in consts)),
            None)
        with self._lock:
            pool = self._pools.get(b)
            if pool is None:
                pool = self._pools[b] = GraphPool()
        side = getattr(self._sides, "stream", None)
        if side is None:
            side = self._sides.stream = torch.cuda.Stream(self.device)
        return pool, side

    def clear(self) -> None:
        """Drop every program built and its graph pool, so the caching
        allocator can hand their memory back (``empty_cache``).  A later
        call at a key builds its program again: ``built()`` counts every
        build, ``built(name)`` the programs held."""
        with self._lock:
            self._programs = {k: p for k, p in self._programs.items()
                              if isinstance(p, _PendingCompile)}
            self._pools.clear()

    def built(self, name: str | None = None) -> int:
        """Programs built: all of them, or those of stage ``name``."""
        with self._lock:
            if name is None:
                return self.n_compiles
            return sum(1 for k, p in self._programs.items()
                       if k[0] == name
                       and not isinstance(p, _PendingCompile))

    def keys(self) -> list:
        """The keys of the programs built."""
        with self._lock:
            return [k for k, p in self._programs.items()
                    if not isinstance(p, _PendingCompile)]

    def pool_sizes(self) -> list:
        """The padded batch sizes that have a graph pool (a card; None
        names the one pool of a ``one_pool`` cache)."""
        with self._lock:
            return sorted(self._pools, key=lambda b: -1 if b is None else b)

    def stats(self) -> dict:
        """Programs built, CUDA graphs among them, their replays and the
        bytes of static inputs and outputs they hold (the graph pools
        hold the captures' intermediates beside)."""
        with self._lock:
            progs = [p for p in self._programs.values()
                     if not isinstance(p, _PendingCompile)]
        stats = [p.stats() for p in progs]
        return {"programs": len(progs),
                "graphs": sum(p.graph for p in progs),
                "replays": sum(s["replays"] for s in stats),
                "static_bytes": sum(s["static_bytes"] for s in stats)}
