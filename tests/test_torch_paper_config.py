"""The port's ``configs/paper_retrieval.py`` against the JAX package's:
the paper's constants and each experiment scale, field for field (exact:
they are the same Python numbers)."""

import dataclasses

import pytest

from repro.configs import paper_retrieval as j_paper
from repro_torch.configs import paper_retrieval as t_paper

CONSTANTS = ("ARCH", "MED_TARGETS_RBP", "MED_TARGETS_DCG", "MED_TARGETS_ERR",
             "CASCADE_THRESHOLDS", "N_FOLDS", "K_VALUES",
             "RHO_VALUES_FRACTION", "BM25_K1", "BM25_B", "LM_MU",
             "N_FEATURES")


def test_paper_constants_equal_jax():
    for name in CONSTANTS:
        assert getattr(t_paper, name) == getattr(j_paper, name), name


@pytest.mark.parametrize("scale", ["default", "bench", "paperish"])
def test_experiment_scales_equal_jax(scale):
    got = dataclasses.asdict(t_paper.experiment_config(scale))
    assert got == dataclasses.asdict(j_paper.experiment_config(scale))
    if scale == "paperish":
        assert {k: got[k] for k in t_paper.PAPERISH} == t_paper.PAPERISH
    with pytest.raises(KeyError):
        t_paper.experiment_config("huge")
