"""The funnel's program cache (ROADMAP item 8i) against the JAX package's
jitted ``_serve_single_dispatch``, on the CPU.

On the tiny funnel of ``tests/test_torch_recsys.py`` (``FUNNEL_KW``,
parameters, requests and cascade carried from the JAX package):

* ``Funnel.n_compiles`` grows exactly as
  ``_serve_single_dispatch._cache_size()`` does over a sequence of
  ``execute`` calls at several batch sizes and class mixes, the depth
  knob among them (deltas: the jit cache is module-wide);
* the ranked lists of those calls, and of a call at every ``max_k`` of
  the grid, equal the JAX package's id for id (on these inputs no two
  neighbours' stage-2 scores come close enough for the float order to
  swap them), and the stage function's called directly;
* ``FunnelBackend.warmup_shape`` builds one program a cutoff (7 on the
  default grid), then none, as the JAX backend's does, and warm traffic
  builds nothing;
* ``retrieval_tower.top_k`` equals ``jax.lax.top_k`` on boundary ties,
  signed zeros, -inf rows, all-equal rows and k = N, and on seeded rows
  drawn from a palette of ties (a hypothesis case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import knobs as j_knobs
from repro.serving import funnel as j_funnel
from repro.serving import service as j_service
from repro_torch.models.recsys import retrieval_tower as t_rt
from repro_torch.serving import funnel as t_funnel
from repro_torch.serving import service as t_service
from test_torch_recsys import FUNNEL_KW, _cfgs, carried  # noqa: F401

#: execute calls: (batch, classes cycled over the batch, depth classes
#: cycled, or None with the depth knob off).  The classes' largest k
#: is the pool width, so the calls revisit keys and add new ones.
CALLS = [
    (24, [0], None),            # k 10
    (24, [0, 2], None),         # k 50
    (24, [1, 0], None),         # k 20
    (24, [0], None),            # a hit
    (40, [3], None),            # the no-envelope class: k 50
    (40, [2, 1], [0, 3]),       # the depth knob: the same key
    (24, [0, 1, 2], [1, 2]),    # a hit
    (13, [1], [2]),             # an odd batch: k 20
    (13, [0, 3], None),         # k 50
]


def _cycle(pattern, n):
    return np.resize(np.asarray(pattern, np.int32), n)


@pytest.fixture(scope="module")
def funnels(carried):
    """Both packages' funnels on the carried parameters, with the depth
    grid declared (execute takes depth classes then)."""
    c = carried
    grid = j_knobs.depth_cutoffs(max(FUNNEL_KW["cutoffs"]))
    jcfg, tcfg = _cfgs(depth_cutoffs=grid)
    jf = j_funnel.Funnel(jcfg, c["jtower"], c["jbst"], c["casc"])
    tf = t_funnel.Funnel(tcfg, c["ttower"], c["tbst"], c["tcasc"],
                         device="cpu")
    r = np.random.default_rng(28)
    uf = r.normal(size=(40, 8)).astype(np.float32)
    hist = r.integers(-1, 500, (40, 6)).astype(np.int32)
    return jf, tf, uf, hist


def test_builds_grow_as_the_jit_cache_and_lists_equal_jax(funnels):
    jf, tf, uf, hist = funnels
    cache = j_funnel._serve_single_dispatch._cache_size
    j0, builds = cache(), []
    for b, cls, dcls in CALLS:
        classes = _cycle(cls, b)
        depth = None if dcls is None else _cycle(dcls, b)
        a = jf.execute(jnp.asarray(uf[:b]), jnp.asarray(hist[:b]), classes,
                       depth_classes=depth)
        t = tf.execute(uf[:b], hist[:b], classes, depth_classes=depth)
        builds.append((tf.n_compiles, cache() - j0))
        np.testing.assert_array_equal(t["k"], a["k"])
        np.testing.assert_array_equal(t["ranked"], a["ranked"])
        assert set(t["timings"]) == {"execute_ms"}
    assert [p for p, _ in builds] == [j for _, j in builds]
    assert [p for p, _ in builds] == [1, 2, 3, 3, 4, 4, 4, 5, 6]
    assert tf.programs.stats()["graphs"] == 0
    assert sorted(k[0] for k in tf.programs.keys()) == [
        "funnel:10", "funnel:20", "funnel:20", "funnel:50", "funnel:50",
        "funnel:50"]


@pytest.mark.parametrize("cls", [0, 1, 2])
def test_program_equals_the_stage_function_at_every_max_k(funnels, cls):
    """A program's lists are those of the stage function called
    directly, at each width of the grid."""
    jf, tf, uf, hist = funnels
    classes = _cycle([cls, 0], 16)
    got = tf.execute(uf[:16], hist[:16], classes)["ranked"]
    ks = tf.params_of(classes)
    _, args, kwargs = tf.stage_call(uf[:16], hist[:16], ks,
                                    np.full_like(ks, max(tf.cfg.cutoffs)))
    want = t_funnel._stage_funnel(*args, **kwargs).numpy()
    np.testing.assert_array_equal(got[:, :want.shape[1]], want)
    a = jf.execute(jnp.asarray(uf[:16]), jnp.asarray(hist[:16]), classes)
    np.testing.assert_array_equal(got, a["ranked"])


def test_clear_drops_the_programs_and_the_next_call_builds_again(carried):
    """``programs.clear()`` drops what the cache holds; the next call at
    a key builds it again (counted), with the same lists."""
    c = carried
    tf = t_funnel.Funnel(_cfgs()[1], c["ttower"], c["tbst"], c["tcasc"],
                         device="cpu")
    assert tf.programs.one_pool
    r = np.random.default_rng(7)
    uf = r.normal(size=(8, 8)).astype(np.float32)
    hist = r.integers(-1, 500, (8, 6)).astype(np.int32)
    classes = _cycle([0, 1], 8)
    want = tf.execute(uf, hist, classes)["ranked"]
    assert tf.n_compiles == 1 and tf.programs.built("funnel:20") == 1
    tf.programs.clear()
    assert tf.programs.keys() == [] and tf.programs.built("funnel:20") == 0
    np.testing.assert_array_equal(tf.execute(uf, hist, classes)["ranked"],
                                  want)
    assert tf.n_compiles == 2 and tf.programs.built("funnel:20") == 1


@pytest.fixture(scope="module")
def wide(carried):
    """The tiny widths on the default cutoff grid (7 cutoffs, a pool of
    1000, as many items): both packages' backends."""
    c = carried
    from repro.models.recsys import bst as j_bst
    from repro.models.recsys import retrieval_tower as j_rt
    from repro_torch import convert
    from repro_torch.models.recsys import bst as t_bst
    tower_kw = dict(d_user_in=8, embed_dim=8, hidden=(16,),
                    n_candidates=1200)
    bst_kw = dict(embed_dim=8, seq_len=6, n_heads=2, item_vocab=1200,
                  n_profile=4, mlp=(16, 8))
    jcfg = j_funnel.FunnelConfig(tower=j_rt.TowerConfig(**tower_kw),
                                 bst=j_bst.BSTConfig(**bst_kw))
    tcfg = t_funnel.FunnelConfig(tower=t_rt.TowerConfig(**tower_kw),
                                 bst=t_bst.BSTConfig(**bst_kw))
    assert len(tcfg.cutoffs) == 7
    jtower = j_rt.init_tower(jcfg.tower, seed=3)
    jbst = j_bst.init_bst(jcfg.bst, seed=4)
    jf = j_funnel.Funnel(jcfg, jtower, jbst, c["casc"])
    tf = t_funnel.Funnel(tcfg, convert.tower_from_numpy(jtower, device="cpu"),
                         convert.bst_from_numpy(jbst, device="cpu"),
                         c["tcasc"], device="cpu")
    return (j_service.FunnelBackend(jf, pad_multiple=8),
            t_service.FunnelBackend(tf, pad_multiple=8))


def test_warmup_builds_every_cutoff_once_and_traffic_builds_none(wide):
    jb, tb = wide
    cache = j_funnel._serve_single_dispatch._cache_size
    j0 = cache()
    assert tb.warmup_shape(8) == jb.warmup_shape(8) == 7
    assert tb.funnel.n_compiles == cache() - j0 == 7
    assert tb.warmup_shape(8) == jb.warmup_shape(8) == 0
    assert tb.funnel.n_compiles == cache() - j0 == 7
    assert tb.n_compiles is jb.n_compiles is None
    r = np.random.default_rng(5)
    payloads = [(r.normal(size=8).astype(np.float32),
                 r.integers(-1, 500, 6).astype(np.int32)) for _ in range(6)]
    batch = tb.collate(payloads)
    for classes in ([0] * 6, [6, 1, 0, 3, 2, 5], [4] * 6):
        results, timings = tb.execute(batch, np.asarray(classes))
        assert len(results) == 6 and set(timings) == {"funnel_ms"}
    assert tb.funnel.n_compiles == 7


# --------------------------------------------------------------- top_k --

def _boundary_rows():
    """Rows where the k-th score ties: a 64-way tie, mixed-sign zeros
    across the boundary, a -inf row, an all-equal row, a row of -inf
    but one, subnormals beside zeros."""
    tie = np.ones(65, np.float32)
    tie[5] = 2.0
    zeros = np.full(65, -1.0, np.float32)
    zeros[:6] = [0.0, -0.0, -0.0, 0.0, 1.0, -1.0]
    zeros[[30, 31, 64]] = [-0.0, 0.0, 0.0]
    one = np.full(65, -np.inf, np.float32)
    one[40] = 0.0
    tiny = np.array([0.0, -0.0, 1e-45, -1e-45] * 16 + [0.0], np.float32)
    return np.stack([tie, zeros, np.full(65, -np.inf, np.float32),
                     np.full(65, 3.0, np.float32), one, tiny, -tiny])


def _assert_top_k(scores, k):
    jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
    ti, tv = t_rt.top_k(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))


@pytest.mark.parametrize("k", [1, 2, 4, 31, 32, 33, 64, 65])
def test_top_k_equals_lax_top_k_on_every_tie_case(k):
    """k up to N = 65, around the 32-wide blocks of the tie pass."""
    _assert_top_k(_boundary_rows(), k)


@settings(max_examples=30, deadline=None)
@given(st.integers(min_value=0, max_value=2 ** 31 - 1),
       st.integers(min_value=1, max_value=130),
       st.integers(min_value=1, max_value=130))
def test_top_k_equals_lax_top_k_on_drawn_ties(seed, n, k):
    r = np.random.default_rng(seed)
    palette = np.array([0.0, -0.0, 1.0, -1.0, 2.5, -np.inf, 1e-45, -1e-45],
                       np.float32)
    scores = r.choice(palette[:r.integers(2, len(palette) + 1)], (3, n))
    scores[0] = r.normal(size=n)
    _assert_top_k(scores.astype(np.float32), min(k, n))
