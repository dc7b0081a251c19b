"""Finding record + baseline-allowlist I/O for the port's invariant
analyzer: a copy of the JAX package's ``analysis/findings.py``.

A finding is keyed by ``(invariant, file, scope, code)`` — line numbers
are deliberately *not* part of the key so unrelated edits above a vetted
exception don't churn the baseline.  The baseline stores a count per key:
``k`` occurrences of the same offending expression in the same scope are
allowed before new ones fail CI (a ratchet, not a mute).
"""

from __future__ import annotations

import collections
import dataclasses
import json

__all__ = ["Finding", "load_baseline", "write_baseline", "apply_baseline"]

BASELINE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    invariant: str        # "recompile/traced-branch", "locks/unguarded", ...
    file: str             # posix path as given on the command line
    line: int
    scope: str            # dotted qualname of the enclosing def
    code: str             # offending source (ast.unparse, truncated)
    message: str
    hint: str

    def key(self) -> tuple[str, str, str, str]:
        return (self.invariant, self.file, self.scope, self.code)

    def format(self, status: str = "") -> str:
        tag = f" [{status}]" if status else ""
        return (f"{self.file}:{self.line}: {self.invariant}{tag} "
                f"in `{self.scope}`\n"
                f"    {self.code}\n"
                f"    {self.message}\n"
                f"    fix: {self.hint}")


def load_baseline(path) -> tuple[collections.Counter, dict]:
    """Returns (allowed counts keyed like Finding.key(), note per key)."""
    with open(path) as f:
        data = json.load(f)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"{path}: unsupported baseline version "
                         f"{data.get('version')!r}")
    allowed: collections.Counter = collections.Counter()
    notes: dict = {}
    for e in data.get("entries", []):
        key = (e["invariant"], e["file"], e["scope"], e["code"])
        allowed[key] += int(e.get("count", 1))
        if e.get("note"):
            notes[key] = e["note"]
    return allowed, notes


def write_baseline(findings, path, notes: dict | None = None) -> None:
    """Serialize current findings as the new allowlist, carrying over any
    notes attached to keys that still occur."""
    notes = notes or {}
    counts = collections.Counter(f.key() for f in findings)
    entries = []
    for key in sorted(counts):
        invariant, file, scope, code = key
        entry = {"invariant": invariant, "file": file, "scope": scope,
                 "code": code, "count": counts[key]}
        if key in notes:
            entry["note"] = notes[key]
        entries.append(entry)
    with open(path, "w") as f:
        json.dump({"version": BASELINE_VERSION, "entries": entries}, f,
                  indent=2, sort_keys=False)
        f.write("\n")


def apply_baseline(findings, allowed: collections.Counter):
    """Split findings into (new, baselined) and report stale allowlist
    entries (vetted exceptions that no longer occur — candidates for
    removal so the ratchet only tightens)."""
    budget = collections.Counter(allowed)
    new, baselined = [], []
    for f in sorted(findings, key=lambda f: (f.file, f.line)):
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
            baselined.append(f)
        else:
            new.append(f)
    stale = {k: n for k, n in budget.items() if n > 0}
    return new, baselined, stale
