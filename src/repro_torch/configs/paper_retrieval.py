"""The paper's own system configuration (MQ2009 / ClueWeb09B analog), a
copy of the JAX package's ``configs/paper_retrieval.py``: knobs,
cutoffs, envelope targets, feature set, cascade hyperparameters, and the
experiment scales the drivers and ``chip_smoke.py`` use.

``SCALES`` holds each scale's overrides of ``ExperimentConfig``'s
defaults (the reference writes them inline in ``experiment_config``).
"""

from __future__ import annotations

from repro_torch.core import experiment as E
from repro_torch.core.labeling import K_CUTOFFS, RHO_FRACTIONS

__all__ = ["ARCH", "SCALES", "PAPERISH", "experiment_config"]

ARCH = "paper-retrieval"

#: paper Section 4 experimental constants
MED_TARGETS_RBP = (0.02, 0.05, 0.10, 0.15, 0.20, 0.25, 0.30, 0.50)
MED_TARGETS_DCG = (0.2, 0.3, 0.5, 0.7, 1.0, 1.2, 1.5)
MED_TARGETS_ERR = (0.05, 0.10, 0.15, 0.20, 0.25, 0.30, 0.50)
CASCADE_THRESHOLDS = (0.75, 0.80, 0.85)
N_FOLDS = 10
K_VALUES = K_CUTOFFS
RHO_VALUES_FRACTION = RHO_FRACTIONS       # of collection postings
BM25_K1, BM25_B = 0.9, 0.4
LM_MU = 2500.0
N_FEATURES = 70

#: scale -> its ``ExperimentConfig`` fields that differ from the defaults
SCALES = {
    "default": {},
    "bench": dict(n_docs=12_000, vocab=20_000, n_queries=1_200,
                  stream_cap=2048, pool_depth=4_000, gold_depth=400),
    "paperish": dict(n_docs=50_000, vocab=60_000, n_queries=8_000,
                     stream_cap=4096, pool_depth=10_000, gold_depth=1000),
}
#: the paper-validation scale (``chip_smoke.py`` serves at it)
PAPERISH = SCALES["paperish"]


def experiment_config(scale: str = "default") -> E.ExperimentConfig:
    return E.ExperimentConfig(**SCALES[scale])
