import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (in a fixture) without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def tiny_system():
    """Shared tiny corpus/index/query system for retrieval tests."""
    from repro.core import experiment as E

    return E.build_system(E.ExperimentConfig(
        n_docs=1500, vocab=4000, n_queries=96, stream_cap=256,
        pool_depth=400, gold_depth=100, query_batch=48, seed=3))
