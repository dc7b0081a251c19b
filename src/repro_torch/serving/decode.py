"""The LM decode step as captured programs, one a (batch, cache length).

The port of the JAX decode bundle's ``serve_step`` (``configs/
lm_common.py``): ``jax.jit(serve_step)`` with the cache donated, keyed
on the shapes and dtypes of its arguments.  ``DecodePrograms`` holds the
programs of one parameter tree in a ``serving/programs.py``
``ProgramCache`` of its own: on a card each is ``transformer.
decode_step`` captured once as a CUDA graph and replayed after that, on
the CPU the step itself.

* The parameters' leaves and the cache's leaves are constants of the
  program: read and written in place, never cloned (at decode_32k the
  cache is tens of GB, which is why the reference donates it).  A
  program is bound to the cache it was built on; a call at its key with
  another cache (or another parameter tree) of the same shapes raises.
* ``token`` and ``pos`` (B,) are copied in; ``next_token`` and
  ``logits`` are cloned out; the cache comes back as itself.
* The key is the reference's jit key: ``decode`` and the shapes and
  dtypes of ``token``, ``pos``, the parameters and the cache, so the
  programs built equal ``jax.jit(serve_step)._cache_size()`` on the
  same calls.

A build runs the stage once eagerly before the capture
(``GraphProgram``), and a decode step writes slot ``pos % S`` of every
cache row.  So a program is built on the step's own ``token`` and
``pos``, by the first call at its key, and never ahead of one: the
eager run writes exactly what the replay after it writes again, and a
build in the middle of a generation leaves its tokens unchanged.  There
is no warmup on dummy positions, which would overwrite live slots.

The decode step reaches no hand-written kernel (its attention is torch
ops, as the reference's decode is jnp), so a replay counts no launch.
A failed build or replay raises; nothing runs the step eagerly in its
place.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.models import transformer as T
from repro_torch.serving.programs import ProgramCache
from repro_torch.tree import leaves, map_tree, unflatten

__all__ = ["DecodePrograms"]


def _stage_decode(token, pos, *tensors, cfg, params_like, cache_like):
    """``decode_step`` over flat tensors: (next_token, logits).  The
    parameters' leaves come first, then the cache's, in ``leaves``
    order; ``params_like`` and ``cache_like`` give the trees."""
    n = len(leaves(params_like))
    params = unflatten(params_like, list(tensors[:n]))
    cache = unflatten(cache_like, list(tensors[n:]))
    next_token, logits, _ = T.decode_step(params, cfg, cache, token, pos)
    return next_token, logits


class DecodePrograms:
    """``decode_step`` of one parameter tree as shape-keyed programs on
    the parameters' device.

    ``programs(params, cache, token, pos)`` returns ``decode_step``'s
    (next_token, logits, cache), with the cache written in place; the
    first call at a (batch, cache length) builds its program on its own
    inputs."""

    def __init__(self, params: dict, cfg):
        self.cfg = cfg
        self._params = tuple(leaves(params))
        self.device = self._params[0].device
        self.programs = ProgramCache(self.device, consts=self._params)
        self._like = dict(cfg=cfg, params_like=map_tree(lambda _: None,
                                                        params))
        self._lock = threading.Lock()
        self._bound: dict = {}       # key -> the cache leaves it was built on

    @property
    def n_compiles(self) -> int:
        """Programs built: one a (batch, cache length) and dtypes."""
        return self.programs.built()

    def stats(self) -> dict:
        return self.programs.stats()

    def __call__(self, params: dict, cache: dict, token: torch.Tensor,
                 pos: torch.Tensor):
        p_leaves, c_leaves = tuple(leaves(params)), tuple(leaves(cache))
        if len(p_leaves) != len(self._params) or any(
                a is not b for a, b in zip(p_leaves, self._params)):
            raise ValueError("DecodePrograms: a parameter is not a tensor "
                             "of the tree the programs were made for")
        args = (token, pos) + p_leaves + c_leaves
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        with self._lock:
            bound = self._bound.get(key)
        if bound is not None and any(a is not b
                                     for a, b in zip(c_leaves, bound)):
            raise ValueError("DecodePrograms: the program of this batch and "
                             "cache length was built on another cache; a "
                             "program reads and writes its cache in place")
        kwargs = dict(self._like, cache_like=map_tree(lambda _: None, cache))
        prog = self.programs.compiled("decode", _stage_decode, args, kwargs,
                                      consts=c_leaves)
        with self._lock:
            self._bound.setdefault(key, c_leaves)
        next_token, logits = prog(*args)
        return next_token, logits, cache
