"""The programs of the engine's cache: one per stage and input shapes.

The port of what the JAX engine's AOT executables are to its cache
(``ServingEngine._compiled``).  A program runs one stage function at one
key -- the stage's name and its tensor arguments' shapes and dtypes --
with its static configuration bound by keyword.

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
share a ``GraphPool``: one memory pool (a later capture reuses what an
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

from repro_torch.kernels import _build

__all__ = ["EagerProgram", "GraphPool", "GraphProgram", "build_program"]


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
                            pass    # the stage's own error is the one raised
                        raise
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
