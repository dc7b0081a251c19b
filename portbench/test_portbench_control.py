"""The check fails what it must.

* The control: the reference computed in bfloat16 in the program's
  place fails the limits, on the served sample of a whole run (tiny
  size, CPU; its readings at the cells' own size are in PERF.md).
* Faults planted under a whole run of the harness (the look for a card
  skipped): the pool's accumulator left as it started, half of each
  batch left out, a class and a list altered where they are produced.
  Each run has to come out not correct.  One card serves a cell, so no
  exchange between cards can be left out.
"""

import time

import pytest
import torch

from portbench import bench, tiny

CPU = torch.device("cpu")
SEED = 918273645


@pytest.fixture(scope="module")
def cached_inputs():
    cache = {}
    make = bench.make_inputs

    def cached(cfg, sd, device, times):
        key = (cfg["knob"], id(sd["corpus"].entropy))
        if key not in cache:
            cache[key] = make(cfg, sd, device, times)
        return cache[key]
    return cached


def _run(cell, control=False):
    out, _ = bench.run(tiny.spec(cell), SEED, 0.6, False, CPU,
                       time.perf_counter(), control=control)
    return out


@pytest.mark.parametrize("cell", ["rho-open", "k-open"])
def test_program_passes_and_control_fails(cell):
    out = _run(cell, control=True)
    limits = tiny.spec(cell)["config"]["limits"]
    assert out["correct"], out["checks"]
    assert any(out["control"][k] > limits[k] for k in limits), out["control"]


def _state_unchanged(monkeypatch):
    from repro_torch.retrieval import jass
    orig = jass.saat_scores_masked

    def fault(ds, im, rho, n_docs, **kw):
        return torch.zeros_like(orig(ds, im, rho, n_docs, **kw))
    monkeypatch.setattr(jass, "saat_scores_masked", fault)


def _half_batch(monkeypatch):
    from repro_torch.serving import engine
    orig = engine._stage1_rho

    def fault(ds, *a, **kw):
        pool = orig(ds, *a, **kw)
        half = pool.shape[0] // 2
        return torch.cat([pool[:half], torch.full_like(pool[half:], -1)])
    monkeypatch.setattr(engine, "_stage1_rho", fault)


def _class_altered(monkeypatch):
    from repro_torch.core import cascade
    orig = cascade.classes_from_proba

    def fault(p0, t):
        c = orig(p0, t)
        return torch.where(c > 0, c - 1, c + 1)
    monkeypatch.setattr(cascade, "classes_from_proba", fault)


def _list_altered(monkeypatch):
    from repro_torch.serving import engine
    orig = engine._stage_rerank

    def fault(stage2, pool, **kw):
        out = orig(stage2, pool, **kw)
        return torch.cat([out[:, 1:2], out[:, :1], out[:, 2:]], dim=1)
    monkeypatch.setattr(engine, "_stage_rerank", fault)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _class_altered, _list_altered])
def test_fault_is_not_correct(fault, monkeypatch, cached_inputs):
    monkeypatch.setattr(bench, "make_inputs", cached_inputs)
    fault(monkeypatch)
    out = _run("rho-open")
    assert not out["correct"], out["checks"]
