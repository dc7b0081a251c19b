"""The port's invariant analyzer: AST lint passes + a runtime sync
sanitizer for the card.

Static entry point (pure ``ast``: imports no torch, executes no code of
the port)::

    python -m repro_torch.analysis src/repro_torch

Passes:

* ``locks``    -- guarded attributes accessed outside their lock
  (``repro_torch.analysis.locks``, a copy of the reference's, with the
  registry the runtime mode shares)
* ``hostsync`` -- stream syncs in hot-path scopes, in torch idiom
  (``repro_torch.analysis.hostsync``)
* ``recompile`` -- graph-capture hazards in the scopes the engine's
  program cache captures (``repro_torch.analysis.recompile``, the
  counterpart of the reference's pass of that name)
* ``kernels`` -- the launch discipline of the kernel wrappers: every
  launch checked and counted, no fallback around a launch, the plain
  version only on a CPU tensor (``repro_torch.analysis.kernels``, the
  counterpart of the reference's ``pallas`` pass: the kernels are CUDA
  C++, which a Python AST cannot read, so the pass reads the wrappers
  that launch them, and ``chip_smoke.py``'s phase 1 holds the kernels
  against their plain versions)

Runtime sanitizers (import separately -- they import torch):
``repro_torch.analysis.sanitizers`` -- ``no_syncs`` (torch's sync debug
mode on the card, each sync's frame held against the vetted scopes),
``compile_sentinel`` and ``hot_path`` (no program built in a block, and
on the card no unvetted sync either), ``lock_order`` (instrumented
locks + deadlock-cycle detection).

Vetted exceptions live in ``src/repro_torch/analysis/baseline.json``,
each with a note; the CLI fails only on findings not covered there.
"""

from __future__ import annotations

import ast
import os

from repro_torch.analysis import hostsync, kernels, locks, recompile
from repro_torch.analysis.findings import Finding

__all__ = ["ALL_PASSES", "DEFAULT_BASELINE", "analyze_paths",
           "analyze_source", "Finding"]

ALL_PASSES = {
    locks.PASS_NAME: locks,
    hostsync.PASS_NAME: hostsync,
    recompile.PASS_NAME: recompile,
    kernels.PASS_NAME: kernels,
}

#: the port's committed allowlist
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


def analyze_source(source: str, path: str,
                   passes=None) -> list[Finding]:
    """Run the selected passes over one file's source text."""
    tree = ast.parse(source, filename=path)
    findings: list[Finding] = []
    for name, mod in ALL_PASSES.items():
        if passes is not None and name not in passes:
            continue
        findings.extend(mod.run(tree, path))
    return findings


def _iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if not d.startswith(".") and d != "__pycache__")
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def analyze_paths(paths, passes=None) -> list[Finding]:
    findings: list[Finding] = []
    for path in _iter_py_files(paths):
        rel = os.path.relpath(path).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            src = f.read()
        findings.extend(analyze_source(src, rel, passes=passes))
    return findings
