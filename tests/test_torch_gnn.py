"""The port's GraphSAGE (graph data, CSR, sampler, model, config, the
parameter carrier and the driver) against the JAX package's, on the CPU
at smoke size.

The same seeded numpy inputs go to both packages.  Tolerances, with
their reasons:
  * graphs, molecule batches, the CSR (host and torch-built), the host
    sampler, the port's neighbour pick fed numpy's bits, ``init_sage``
    and the carried parameters: equal (the same numpy draws and integer
    arithmetic; a stable sort has one answer).
  * logits, predictions and losses: rtol 1e-5 / atol 1e-6; float32
    products and sums run in another order than XLA's.
  * gradients: rtol 1e-4 / atol 1e-6 of each leaf; the fixed-order
    segment sums add in another order than XLA's ``segment_sum``, and
    the backward of the L2 normalisation divides by small norms.
  * five AdamW steps of blocks training: losses within 1e-5 relative
    (the gradients above, through Adam).
"""

import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import graphsage_reddit as j_cfg
from repro.data import graph_data as j_data
from repro.launch.mesh import make_smoke_mesh
from repro.models import gnn as j_gnn
from repro.models import sampler as j_sampler
from repro.optim import adamw as j_adamw
from repro_torch import convert
from repro_torch.configs import graphsage_reddit as t_cfg
from repro_torch.data import graph_data as t_data
from repro_torch.examples import gnn_sage as t_example
from repro_torch.launch.train import make_step, value_and_grad
from repro_torch.models import gnn as t_gnn
from repro_torch.models import sampler as t_sampler
from repro_torch.optim import adamw as t_adamw
from repro_torch.tree import leaves

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4

GRAPHS = (dict(n_nodes=300, n_edges=1800, d_feat=16, n_classes=5, seed=0),
          dict(n_nodes=97, n_edges=40, d_feat=3, n_classes=41, seed=7))


def _graph(i=0):
    gcfg = GRAPHS[i]
    return (j_data.make_graph(j_data.GraphConfig(**gcfg)),
            t_data.make_graph(t_data.GraphConfig(**gcfg)))


def _params(cfg, seed=0):
    """The reference's parameters (numpy) and the port's carried copy."""
    jp = j_gnn.init_sage(cfg, seed=seed)
    return jp, convert.sage_from_numpy(jp, device=CPU)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def _grads_close(t_grads, j_grads):
    jl = jax.tree_util.tree_leaves(j_grads)
    tl = leaves(t_grads)
    assert len(jl) == len(tl)
    for g_t, g_j in zip(tl, jl):
        assert np.isfinite(np.asarray(g_j)).all()
        _close(g_t, g_j, GRAD_RTOL, ATOL)


# ----------------------------------------------------------------- data --

@pytest.mark.parametrize("i", range(len(GRAPHS)))
def test_make_graph_is_bit_equal(i):
    jg, tg = _graph(i)
    assert jg.keys() == tg.keys()
    for k in jg:
        assert jg[k].dtype == tg[k].dtype and np.array_equal(jg[k], tg[k]), k


def test_molecule_batch_is_bit_equal():
    jm = j_data.molecule_batch(16, 30, 64, 32, seed=3)
    tm = t_data.molecule_batch(16, 30, 64, 32, seed=3)
    for k in jm:
        assert jm[k].dtype == tm[k].dtype and np.array_equal(jm[k], tm[k]), k


@pytest.mark.parametrize("i", range(len(GRAPHS)))
def test_csr_from_edges_is_bit_equal_on_host_and_torch(i):
    jg, _ = _graph(i)
    n = GRAPHS[i]["n_nodes"]
    j_ptr, j_idx = j_sampler.csr_from_edges(jg["edges"], n)
    t_ptr, t_idx = t_sampler.csr_from_edges(jg["edges"], n)
    assert t_ptr.dtype == j_ptr.dtype and np.array_equal(t_ptr, j_ptr)
    assert t_idx.dtype == j_idx.dtype and np.array_equal(t_idx, j_idx)
    d_ptr, d_idx = t_sampler.csr_from_edges(jg["edges"], n, device=CPU)
    assert d_ptr.dtype == torch.int64 and d_idx.dtype == torch.int32
    assert np.array_equal(d_ptr.numpy(), j_ptr)
    assert np.array_equal(d_idx.numpy(), j_idx)


# -------------------------------------------------------------- sampler --

def test_sample_blocks_np_and_pick_equal_the_reference():
    jg, _ = _graph(1)                   # 97 nodes, 40 edges: many degree 0
    ptr, idx = j_sampler.csr_from_edges(jg["edges"], 97)
    seeds = np.arange(0, 97, 3, dtype=np.int32)
    fanouts = (4, 3)
    j_fr, j_bl = j_sampler.sample_blocks_np(np.random.default_rng(5), ptr,
                                            idx, seeds, fanouts)
    t_fr, t_bl = t_sampler.sample_blocks_np(np.random.default_rng(5), ptr,
                                            idx, seeds, fanouts)
    for a, b in zip(j_fr, t_fr):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(j_bl, t_bl):
        assert a["n_dst"] == b["n_dst"]
        for k in ("src_index", "dst_index"):
            assert np.array_equal(a[k], b[k])
    # the tensor sampler's pick, fed numpy's bits, gives the same frontiers
    rng = np.random.default_rng(5)
    ptr_t, idx_t = torch.from_numpy(ptr), torch.from_numpy(idx)
    cur = torch.from_numpy(seeds)
    for f, want in zip(fanouts, j_fr[1:]):
        r = torch.from_numpy(rng.integers(0, 1 << 30, size=(len(cur), f)))
        cur = t_sampler.pick_neighbours(r, cur, ptr_t, idx_t).reshape(-1)
        assert cur.dtype == torch.int32 and np.array_equal(cur.numpy(), want)
    # and the block layout of the jitted sampler
    gen = torch.Generator().manual_seed(0)
    s_fr, s_bl = t_sampler.sample_blocks(gen, ptr_t, idx_t,
                                         torch.from_numpy(seeds), fanouts)
    for a, b, fr in zip(j_bl, s_bl, s_fr[1:]):
        assert a["n_dst"] == b["n_dst"] and len(fr) == len(a["src_index"])
        for k in ("src_index", "dst_index"):
            assert b[k].dtype == torch.int32
            assert np.array_equal(a[k], b[k].numpy())


def test_sampler_degree_semantics():
    # tests/test_models_smoke.py::test_sampler_degree_semantics on the port
    edges = np.array([[0, 1, 2, 2], [1, 2, 0, 0]], np.int32)
    indptr, indices = t_sampler.csr_from_edges(edges, 4, device=CPU)
    gen = torch.Generator().manual_seed(1)
    fr, _ = t_sampler.sample_blocks(gen, indptr, indices,
                                    torch.tensor([0, 3], dtype=torch.int32),
                                    (4,))
    neigh = fr[1].reshape(2, 4).numpy()
    assert set(neigh[0]) == {2}
    assert set(neigh[1]) == {3}   # isolated -> self-loop


# ---------------------------------------------------------------- model --

def test_init_sage_and_carried_params_are_bit_equal():
    for cfg in (t_cfg.smoke_config(), t_cfg.model_config("molecule")):
        jc = j_gnn.SageConfig(**dataclasses.asdict(cfg))
        jp = j_gnn.init_sage(jc, seed=4)
        tp = t_gnn.init_sage(cfg, seed=4, device=CPU)
        carried = convert.sage_from_numpy(jp, device=CPU)
        jl = jax.tree_util.tree_leaves(jp)
        assert len(jl) == len(leaves(tp)) == len(leaves(carried))
        for a, b, c in zip(jl, leaves(tp), leaves(carried)):
            assert b.dtype == c.dtype == torch.float32
            assert np.array_equal(a, b.numpy())
            assert np.array_equal(a, c.numpy())
    abstract = t_gnn.init_sage(t_cfg.model_config(), abstract=True)
    assert abstract["layers"][0]["w_self"].shape == (602, 128)


def _full_inputs(cfg, i=0):
    jg, _ = _graph(i)
    return jg["feats"][:, :cfg.d_in], jg["edges"], jg["labels"] % \
        cfg.n_classes, jg["train_mask"]


@pytest.mark.parametrize("dead_rows", [False, True])
def test_full_forward_loss_and_grads_equal_jax(dead_rows):
    cfg = t_cfg.smoke_config()
    jc = j_gnn.SageConfig(**dataclasses.asdict(cfg))
    jp, tp = _params(cfg)
    if dead_rows:        # relu zeroes whole rows: the norm's NaN gradient
        jp["layers"][0]["b"] = np.full_like(jp["layers"][0]["b"], -1.0)
        tp["layers"][0]["b"] = torch.full_like(tp["layers"][0]["b"], -1.0)
    x, e, y, m = _full_inputs(cfg)
    jlogits = j_gnn.sage_forward_full(jp, jc, jnp.asarray(x), jnp.asarray(e))
    tx, te = torch.from_numpy(x), torch.from_numpy(e)
    _close(t_gnn.sage_forward_full(tp, cfg, tx, te), jlogits)
    if dead_rows:
        h = np.maximum(x @ jp["layers"][0]["w_self"] + jp["layers"][0]["b"],
                       0)
        assert 0 < (h.max(axis=1) <= 0).sum() < len(h)
        # the reference's gradient of the norm is NaN on a dead row
        def norm_of_dead_row(o):
            return jnp.linalg.norm(o, axis=-1).sum()
        g = jax.grad(norm_of_dead_row)(jnp.zeros((1, 4)))
        assert np.isnan(np.asarray(g)).all()
    jl, jg = jax.value_and_grad(lambda p: j_gnn.sage_loss_full(
        p, jc, jnp.asarray(x), jnp.asarray(e), jnp.asarray(y),
        jnp.asarray(m)))(jp)
    tl, tg = value_and_grad(lambda p: t_gnn.sage_loss_full(
        p, cfg, tx, te, torch.from_numpy(y), torch.from_numpy(m)), tp)
    _close(tl, jl)
    _grads_close(tg, jg)


def _blocks(i=0, seed=2, batch=24, fanouts=(4, 3)):
    jg, _ = _graph(i)
    n = GRAPHS[i]["n_nodes"]
    ptr, idx = j_sampler.csr_from_edges(jg["edges"], n)
    rng = np.random.default_rng(seed)
    seeds = rng.choice(n, batch, replace=False).astype(np.int32)
    fr, bl = j_sampler.sample_blocks_np(rng, ptr, idx, seeds, fanouts)
    return jg, fr, bl, seeds


def _as_torch_blocks(jg, fr, bl, seeds):
    feats = [torch.from_numpy(jg["feats"][f]) for f in fr]
    blocks = [{"src_index": torch.from_numpy(b["src_index"]),
               "dst_index": torch.from_numpy(b["dst_index"]),
               "n_dst": b["n_dst"]} for b in bl]
    return {"feats": feats, "blocks": blocks,
            "labels": torch.from_numpy(jg["labels"][seeds] % 5)}


def _as_jax_blocks(jg, fr, bl, seeds):
    feats = [jnp.asarray(jg["feats"][f]) for f in fr]
    blocks = [{"src_index": jnp.asarray(b["src_index"]),
               "dst_index": jnp.asarray(b["dst_index"]),
               "n_dst": b["n_dst"]} for b in bl]
    return feats, blocks, jnp.asarray(jg["labels"][seeds] % 5)


@pytest.mark.parametrize("dead_rows", [False, True])
def test_blocks_forward_loss_and_grads_equal_jax(dead_rows):
    cfg = t_cfg.smoke_config()
    jc = j_gnn.SageConfig(**dataclasses.asdict(cfg))
    jp, tp = _params(cfg, seed=1)
    if dead_rows:
        jp["layers"][1]["b"] = np.full_like(jp["layers"][1]["b"], -0.3)
        tp["layers"][1]["b"] = torch.full_like(tp["layers"][1]["b"], -0.3)
    data = _blocks()
    jf, jb, jy = _as_jax_blocks(*data)
    tb = _as_torch_blocks(*data)
    _close(t_gnn.sage_forward_blocks(tp, cfg, tb["feats"], tb["blocks"]),
           j_gnn.sage_forward_blocks(jp, jc, jf, jb))
    jl, jg = jax.value_and_grad(
        lambda p: j_gnn.sage_loss_blocks(p, jc, jf, jb, jy))(jp)
    tl, tg = value_and_grad(lambda p: t_example.blocks_loss(p, cfg, tb), tp)
    _close(tl, jl)
    _grads_close(tg, jg)


def test_molecule_regression_loss_and_grads_equal_jax():
    cfg = t_cfg.model_config("molecule")
    jc = j_gnn.SageConfig(**dataclasses.asdict(cfg))
    jp, tp = _params(cfg, seed=3)
    b = 8
    mb = j_data.molecule_batch(b, 30, 64, cfg.d_in, seed=1)
    args_j = [jnp.asarray(mb[k]) for k in ("feats", "edges", "graph_id", "y")]
    args_t = [torch.from_numpy(mb[k]) for k in ("feats", "edges", "graph_id",
                                                "y")]
    _close(t_gnn.sage_graph_regression(tp, cfg, *args_t[:3], b),
           j_gnn.sage_graph_regression(jp, jc, *args_j[:3], b))
    jl, jg = jax.value_and_grad(
        lambda p: j_gnn.sage_loss_molecule(p, jc, *args_j, b))(jp)
    tl, tg = value_and_grad(
        lambda p: t_gnn.sage_loss_molecule(p, cfg, *args_t, b), tp)
    _close(tl, jl)
    _grads_close(tg, jg)


def test_five_adamw_steps_of_blocks_training_equal_jax():
    cfg = t_cfg.smoke_config()
    jc = j_gnn.SageConfig(**dataclasses.asdict(cfg))
    jp, tp = _params(cfg, seed=0)
    j_acfg = j_adamw.AdamWConfig(lr=5e-3, weight_decay=0.0)
    j_opt = j_adamw.init_opt_state(jp)
    t_opt = t_adamw.init_opt_state(tp)
    step = make_step(t_example.blocks_loss, cfg,
                     t_adamw.AdamWConfig(lr=5e-3, weight_decay=0.0))

    @jax.jit
    def j_step(p, o, feats, blocks, labels):
        loss, g = jax.value_and_grad(lambda q: j_gnn.sage_loss_blocks(
            q, jc, feats, blocks, labels))(p)
        p, o, _ = j_adamw.adamw_update(j_acfg, p, g, o)
        return p, o, loss

    j_losses, t_losses = [], []
    for s in range(5):
        data = _blocks(seed=10 + s)
        jf, jb, jy = _as_jax_blocks(*data)
        jb = [{k: v for k, v in b.items() if k != "n_dst"} for b in jb]
        jp, j_opt, jl = j_step(jp, j_opt, jf, jb, jy)
        tp, t_opt, m = step(tp, t_opt, _as_torch_blocks(*data))
        j_losses.append(float(jl))
        t_losses.append(float(m["loss"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)


def test_model_flops_equal_the_reference_bundles():
    mesh = make_smoke_mesh()
    for shape in j_cfg.SHAPES:
        want = j_cfg.dryrun_bundle(shape, mesh).meta["model_flops"]
        assert t_cfg.model_flops(shape) == want, shape


# --------------------------------------------------------------- driver --

def test_driver_runs_on_the_cpu_with_the_reference_lines():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        t_example.main(["--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 7
    for i, ln in enumerate(lines[:6]):
        assert re.fullmatch(rf"step {10 * i:3d}  sampled-loss \d+\.\d{{3}}  "
                            r"full-graph acc \d\.\d{3}", ln), ln
    assert lines[-1] == ("done — sampled training transfers to full-graph "
                         "inference")
    acc = [float(ln.split()[-1]) for ln in lines[:6]]
    assert acc[-1] > acc[0]
