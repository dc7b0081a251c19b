"""The frozen roofline yardstick against the kernel table's shapes
(PERF.md section 6, rows 1 and 2)."""

import numpy as np
import pytest

from portbench import costs

RHO_CUTS = (8, 16, 40, 81, 163, 409, 819, 1638, 4096)


def test_impact_scan_row_1():
    q, p, n_docs = 128, 4096, 50_000
    rho = np.resize(RHO_CUTS, q)
    live = int(np.minimum(rho, p).sum())
    n_bytes, n_ops = costs.impact_scan_cost(q, p, n_docs, live, block_p=512)
    assert round(n_bytes / 1e6, 1) == 26.4
    t, by = costs.bound_s(n_bytes, n_ops)
    assert by == "bytes"
    assert round(t * 1e3, 5) == 0.00789


def test_topk_row_2():
    n_bytes, n_ops = costs.topk_cost(128, 50_000, 100, block_n=4096)
    assert round(n_bytes / 1e6, 1) == 26.9
    t, by = costs.bound_s(n_bytes, n_ops)
    assert by == "bytes"
    assert round(t * 1e3, 5) == 0.00804


@pytest.mark.parametrize("q", [8, 24, 128])
def test_costs_grow_with_the_batch(q):
    a = costs.impact_scan_cost(q, 4096, 50_000, live=0)[0]
    b = costs.impact_scan_cost(q, 4096, 50_000, live=1000)[0]
    assert b - a == 8000
    assert costs.topk_cost(q, 50_000, 100)[0] == q * (50_000 * 4 + 13 * 800)
