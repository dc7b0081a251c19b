"""Named knob registry (numpy copy of ``repro.core.knobs``).

A ``KnobSpec`` is an ordered cutoff grid plus the class -> value mapping
that training, serving and labeling share; ``depth_cutoffs`` builds the
reranking-depth grid as fractions of the candidate-pool width.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["KNOB_NAMES", "DEPTH_FRACTIONS", "KnobSpec", "depth_cutoffs"]

#: the knobs the serving layers know how to mask
KNOB_NAMES = ("rho", "k", "depth")

#: default depth grid as fractions of the candidate-pool width; always
#: ends at 1.0, the knob's own reference (masking there is a no-op)
DEPTH_FRACTIONS = (0.1, 0.2, 0.3, 0.5, 0.7, 0.85, 1.0)


@dataclass(frozen=True)
class KnobSpec:
    """One per-query knob: class ``i < c`` means "cutoffs[i] suffices",
    class ``c`` maps to the grid maximum (the reference)."""

    name: str
    cutoffs: tuple[int, ...]

    def __post_init__(self):
        cuts = tuple(int(v) for v in self.cutoffs)
        if not cuts:
            raise ValueError(f"knob {self.name!r}: empty cutoff grid")
        if any(v <= 0 for v in cuts):
            raise ValueError(
                f"knob {self.name!r}: cutoffs must be positive, got {cuts}")
        if list(cuts) != sorted(cuts):
            # non-decreasing, duplicates allowed: grids clamped to the
            # pool width may repeat the maximum
            raise ValueError(
                f"knob {self.name!r}: cutoffs must be non-decreasing, "
                f"got {cuts}")
        object.__setattr__(self, "cutoffs", cuts)

    @property
    def n_cutoffs(self) -> int:
        return len(self.cutoffs)

    @property
    def n_classes(self) -> int:
        return len(self.cutoffs) + 1

    def reference(self) -> int:
        """The knob's full-fidelity setting."""
        return self.cutoffs[-1]

    def params_of(self, classes, fallback: bool = False) -> np.ndarray:
        """Class ``i`` -> ``cutoffs[min(i, c-1)]``; ``fallback=True`` pins
        everything to the reference."""
        classes = np.asarray(classes)
        cuts = np.asarray(self.cutoffs, np.int64)
        if fallback:
            return np.full(classes.shape, cuts[-1], np.int64)
        return cuts[np.minimum(np.maximum(classes, 0), len(cuts) - 1)]


def depth_cutoffs(pool_width: int,
                  fractions=DEPTH_FRACTIONS) -> tuple[int, ...]:
    """Reranking-depth grid for a pool of ``pool_width``: fractional
    depths, deduplicated, floored at 1, ending exactly at the width."""
    if pool_width <= 0:
        raise ValueError(f"pool_width must be positive, got {pool_width}")
    vals = sorted({max(1, int(round(f * pool_width))) for f in fractions})
    if vals[-1] != pool_width:
        vals.append(pool_width)
    return tuple(v for v in vals if v <= pool_width)
