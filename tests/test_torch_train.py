"""The port's recsys training path (wide-deep, DIEN, BST, MIND, the
two-tower loss, AdamW, schedules, checkpoints, the resilient driver, the
differentiable flash attention and the training CLI) against the JAX
package's, on the CPU, at each arch's smoke config.

The same seeded numpy inputs go to both packages.  Tolerances, with
their reasons:
  * inits, batches, schedules' integer arithmetic, checkpoints: equal
    (the same numpy draws; the same files).
  * logits and losses: rtol 1e-5 / atol 1e-6; float32 products and sums
    run in another order than XLA's.
  * gradients: rtol 1e-4 / atol 1e-6 of each leaf; the gathers'
    backward sums duplicate ids in another order, and DIEN's 12-step
    recurrence compounds the float32 differences.
  * one AdamW update from carried parameters, gradients and state:
    rtol 1e-6 (elementwise float32 in the reference's order).
  * ten training steps (as tests/test_models_smoke.py trains; DIEN's
    loss falls by the tenth): losses within 1e-4 relative (the steps above,
    compounded through Adam).
  * the flash backward: 1e-5 against autograd of the plain attention and
    against ``jax.grad`` of the JAX ``chunked_attention`` (float32 sums
    in another order).
"""

import contextlib
import dataclasses
import functools
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as j_ckpt
from repro.configs import base as j_cfgbase
from repro.data import recsys_data as j_data
from repro.launch import train as j_train
from repro.models import attention as j_attn
from repro.models.recsys import bst as j_bst
from repro.models.recsys import dien as j_dien
from repro.models.recsys import mind as j_mind
from repro.models.recsys import retrieval_tower as j_rt
from repro.models.recsys import wide_deep as j_wd
from repro.optim import adamw as j_adamw
from repro.optim import schedules as j_sched
from repro_torch import convert
from repro_torch.ckpt import checkpoint as t_ckpt
from repro_torch.ckpt import failover as t_failover
from repro_torch.configs import base as t_cfgbase
from repro_torch.data import recsys_data as t_data
from repro_torch.kernels.embedding_bag import kernel as eb_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref_bshd
from repro_torch.kernels.impact_scan import kernel as is_kernel
from repro_torch.kernels.topk import kernel as tk_kernel
from repro_torch.launch import train as t_train
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models.recsys import bst as t_bst
from repro_torch.models.recsys import dien as t_dien
from repro_torch.models.recsys import embedding as t_emb
from repro_torch.models.recsys import mind as t_mind
from repro_torch.models.recsys import retrieval_tower as t_rt
from repro_torch.models.recsys import wide_deep as t_wd
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import schedules as t_sched
from repro_torch.tree import leaves_with_paths

ARCHS = ["wide-deep", "dien", "bst", "mind", "tower"]
TOWER_KW = dict(d_user_in=8, embed_dim=8, hidden=(16,), n_candidates=300)
# arch -> (JAX init, loss, port init, loss, batch fn name, batch, seed):
# the batches of tests/test_models_smoke.py
FAMILIES = {
    "wide-deep": (j_wd.init_wide_deep, j_wd.wide_deep_loss,
                  t_wd.init_wide_deep, t_wd.wide_deep_loss,
                  "wide_deep_batch", 64, 2),
    "dien": (j_dien.init_dien, j_dien.dien_loss, t_dien.init_dien,
             t_dien.dien_loss, "dien_batch", 32, 3),
    "bst": (j_bst.init_bst, j_bst.bst_loss, t_bst.init_bst, t_bst.bst_loss,
            "bst_batch", 32, 4),
    "mind": (j_mind.init_mind, j_mind.mind_loss, t_mind.init_mind,
             t_mind.mind_loss, "mind_batch", 32, 5),
    "tower": (j_rt.init_tower, j_rt.tower_loss, t_rt.init_tower,
              t_rt.tower_loss, "tower_batch", 32, 6),
}


def _cfgs(arch):
    if arch == "tower":
        return j_rt.TowerConfig(**TOWER_KW), t_rt.TowerConfig(**TOWER_KW)
    return (j_cfgbase.get(arch).smoke_config(),
            t_cfgbase.get(arch).smoke_config())


def _batch(arch, cfg, step):
    _, _, _, _, fn, b, seed = FAMILIES[arch]
    return getattr(j_data, fn)(cfg, b, step, seed=seed)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _named(tree):
    return {"::".join(map(str, p)): leaf
            for p, leaf in leaves_with_paths(tree)}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_trees(got, want, **tol):
    got, want = _named(got), _named(want)
    assert got.keys() == want.keys()
    for name in want:
        if tol:
            np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                       err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(_np(got[name]), _np(want[name]),
                                          err_msg=name)


def _grads(loss_fn, params, cfg, batch):
    flat = [leaf for _, leaf in leaves_with_paths(params)]
    for p in flat:
        p.requires_grad_(True)
    loss = loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, flat)
    for p in flat:
        p.requires_grad_(False)
    return loss.detach(), dict(zip(_named(params), grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_equals_jax(arch):
    j_init, _, t_init, _, _, _, _ = FAMILIES[arch]
    jc, tc = _cfgs(arch)
    _assert_trees(t_init(tc, seed=7, device="cpu"), j_init(jc, seed=7))


def test_wide_deep_field_by_field_draw_is_the_one_call_draw():
    jc, tc = _cfgs("wide-deep")
    jc, tc = (dataclasses.replace(c, n_sparse=5, vocab_per_field=333,
                                  embed_dim=6) for c in (jc, tc))
    got = t_wd.init_wide_deep(tc, seed=3, device="cpu")["deep_table"]
    want = np.random.default_rng(3).normal(
        0, 6 ** -0.5, (5, 333, 6)).astype(np.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, j_wd.init_wide_deep(jc, seed=3)["deep_table"])


def test_configs_copy_the_jax_numbers(monkeypatch):
    for arch in t_cfgbase.RECSYS_ARCHS:
        j_mod, t_mod = j_cfgbase.get(arch), t_cfgbase.get(arch)
        assert t_mod.ARCH == j_mod.ARCH and t_mod.SHAPES == j_mod.SHAPES
        for name in ("model_config", "smoke_config"):
            jc, tc = getattr(j_mod, name)(), getattr(t_mod, name)()
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), arch
            for b, kind in ((65536, "train"), (512, "serve")):
                assert t_mod._model_flops(tc, b, kind) == \
                    j_mod._model_flops(jc, b, kind)
    monkeypatch.setenv("REPRO_RETRIEVAL_BF16", "1")
    assert t_cfgbase.get("mind").model_config().dtype == "bfloat16" == \
        j_cfgbase.get("mind").model_config().dtype
    # the GNN (ROADMAP item 7e, done)
    j_mod, t_mod = (m.get("graphsage-reddit") for m in (j_cfgbase, t_cfgbase))
    assert t_mod.ARCH == j_mod.ARCH and t_mod.SHAPES == j_mod.SHAPES
    assert t_mod.SKIPS == j_mod.SKIPS
    for shape in j_mod.SHAPES:
        assert dataclasses.asdict(t_mod.model_config(shape)) == \
            dataclasses.asdict(j_mod.model_config(shape)), shape
    assert dataclasses.asdict(t_mod.smoke_config()) == \
        dataclasses.asdict(j_mod.smoke_config())
    with pytest.raises(KeyError, match="not ported"):
        t_cfgbase.get("no-such-arch")


def test_mind_bfloat16_init_equals_jax():
    jc, tc = (dataclasses.replace(c, dtype="bfloat16")
              for c in _cfgs("mind"))
    got = t_mind.init_mind(tc, seed=1, device="cpu")
    want = j_mind.init_mind(jc, seed=1)
    for name in want:
        assert got[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[name].float().numpy(), np.asarray(want[name], np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_jax(arch):
    jc, tc = _cfgs(arch)
    _, _, _, _, fn, b, seed = FAMILIES[arch]
    for step in (0, 5):
        want = getattr(j_data, fn)(jc, b, step, seed=seed, host=1)
        got = getattr(t_data, fn)(tc, b, step, seed=seed, host=1)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@functools.lru_cache(maxsize=None)
def _jax_run(arch, steps=10):
    """tests/test_models_smoke.py's ``_train_some`` (AdamW at lr 3e-3, no
    weight decay) in one jitted step that also returns the gradients:
    (losses, the first step's gradients by leaf name)."""
    j_init, j_loss, _, _, _, _, _ = FAMILIES[arch]
    jc, _ = _cfgs(arch)
    cfg = j_adamw.AdamWConfig(lr=3e-3, weight_decay=0.0)
    params = j_init(jc, seed=0)
    opt = j_adamw.init_opt_state(params)

    @jax.jit
    def step(p, o, b):
        loss, g = jax.value_and_grad(lambda p: j_loss(p, jc, b))(p)
        p, o, _ = j_adamw.adamw_update(cfg, p, g, o)
        return p, o, loss, g

    losses = []
    for i in range(steps):
        params, opt, loss, g = step(params, opt, _j(_batch(arch, jc, i)))
        losses.append(float(loss))
        if i == 0:
            grads0 = {k: np.asarray(v) for k, v in _named(g).items()}
    return losses, grads0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    _, _, t_init, t_loss, _, _, _ = FAMILIES[arch]
    jc, tc = _cfgs(arch)
    got, tg = _grads(t_loss, t_init(tc, seed=0, device="cpu"), tc,
                     _t(_batch(arch, jc, 0)))
    losses, jg = _jax_run(arch)
    np.testing.assert_allclose(float(got), losses[0], rtol=1e-5, atol=1e-6)
    assert tg.keys() == jg.keys()
    for name, g in tg.items():
        assert g.abs().max() > 0 or not np.any(jg[name]), name
        np.testing.assert_allclose(g.numpy(), jg[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_logits_match_jax():
    for arch, j_fn, t_fn in (
            ("wide-deep", j_wd.wide_deep_logits, t_wd.wide_deep_logits),
            ("bst", j_bst.bst_logits, t_bst.bst_logits)):
        j_init, _, t_init, _, _, _, _ = FAMILIES[arch]
        jc, tc = _cfgs(arch)
        batch = _batch(arch, jc, 2)
        np.testing.assert_allclose(
            t_fn(t_init(tc, device="cpu"), tc, _t(batch)).numpy(),
            np.asarray(jax.jit(lambda p, b: j_fn(p, jc, b))(
                j_init(jc), _j(batch))), rtol=1e-5, atol=1e-6)
    jc, tc = _cfgs("dien")
    batch = _batch("dien", jc, 2)
    got = t_dien.dien_logits(t_dien.init_dien(tc, device="cpu"), tc,
                             _t(batch), return_aux=True)
    want = jax.jit(lambda p, b: j_dien.dien_logits(p, jc, b,
                                                   return_aux=True))(
        j_dien.init_dien(jc), _j(batch))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    jc, tc = _cfgs("mind")
    batch = _batch("mind", jc, 2)
    tp, jp = t_mind.init_mind(tc, device="cpu"), j_mind.init_mind(jc)
    tv = t_mind.mind_interests(tp, tc, torch.from_numpy(batch["hist_items"]))
    jv = jax.jit(lambda p, h: j_mind.mind_interests(p, jc, h))(
        jp, jnp.asarray(batch["hist_items"]))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    te = tp["item_table"][torch.from_numpy(batch["target_item"]).long()]
    np.testing.assert_allclose(
        t_mind.mind_score(tp, tc, tv, te).numpy(),
        np.asarray(j_mind.mind_score(jp, jc, jv, jnp.asarray(te.numpy()))),
        rtol=1e-5, atol=1e-6)


def test_adamw_update_matches_jax():
    jc, tc = _cfgs("bst")
    params = j_bst.init_bst(jc, seed=2)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(
        lambda p: rng.normal(0, 3.0, p.shape).astype(np.float32), params)
    state = {"m": jax.tree.map(lambda p: rng.normal(0, 0.1, p.shape)
                               .astype(np.float32), params),
             "v": jax.tree.map(lambda p: rng.random(p.shape)
                               .astype(np.float32), params),
             "step": np.int32(4)}
    cfg = dict(lr=3e-3, weight_decay=1e-2, grad_clip=1.0)
    jp, js, jm = jax.jit(functools.partial(
        j_adamw.adamw_update, j_adamw.AdamWConfig(**cfg)))(
        params, grads, state)
    assert float(jm["clip"]) < 0.1          # the clip engages
    tp = convert.bst_from_numpy(params, device="cpu")
    ts = convert.adamw_state_from_numpy(state, tp)
    tg = convert.bst_from_numpy(grads, device="cpu")
    tp, ts, tm = t_adamw.adamw_update(t_adamw.AdamWConfig(**cfg), tp, tg, ts)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["clip"]), float(jm["clip"]),
                               rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 5
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        _assert_trees(got, want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_some_matches_jax(arch):
    _, _, t_init, t_loss, _, _, _ = FAMILIES[arch]
    jc, tc = _cfgs(arch)
    step = t_train.make_step(t_loss, tc, t_adamw.AdamWConfig(
        lr=3e-3, weight_decay=0.0))
    params = t_init(tc, seed=0, device="cpu")
    opt = t_adamw.init_opt_state(params)
    losses = []
    for i in range(10):
        params, opt, m = step(params, opt, _t(_batch(arch, jc, i)))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, _jax_run(arch)[0], rtol=1e-4)
    assert losses[-1] < losses[0]


def test_schedules_equal_jax():
    for step in (0, 1, 7, 20, 150, 999, 5000):
        for kw in (dict(warmup=20, total=1000), dict(warmup=0, total=10)):
            for name in ("warmup_cosine", "warmup_linear_decay"):
                j_fn, t_fn = getattr(j_sched, name), getattr(t_sched, name)
                for s_j, s_t in ((step, step),
                                 (jnp.int32(step), torch.tensor(step))):
                    np.testing.assert_allclose(
                        float(t_fn(s_t, **kw)), float(j_fn(s_j, **kw)),
                        rtol=1e-6, err_msg=f"{name} {step} {kw}")
        assert t_sched.constant(step) == j_sched.constant(step) == 1.0


def _state(arch, seed):
    j_init, _, t_init, _, _, _, _ = FAMILIES[arch]
    jc, tc = _cfgs(arch)
    jp = j_init(jc, seed=seed)
    tp = t_init(tc, seed=seed, device="cpu")
    return ({"params": jp, "opt": j_adamw.init_opt_state(jp)},
            {"params": tp, "opt": t_adamw.init_opt_state(tp)})


def test_checkpoints_move_across_both_ways(tmp_path):
    js, ts = _state("dien", 1)
    js_other, ts_other = _state("dien", 2)
    ts["opt"]["step"] = torch.tensor(9, dtype=torch.int32)
    t_ckpt.save(str(tmp_path / "t"), ts, 9, extra={"who": "torch"})
    back, extra = j_ckpt.restore(str(tmp_path / "t"), js_other)
    assert extra == {"who": "torch"}
    _assert_trees(back, ts)
    assert np.asarray(back["opt"]["step"]).shape == ()
    j_ckpt.save(str(tmp_path / "j"), jax.tree.map(jnp.asarray, js), 4)
    back, _ = t_ckpt.restore(str(tmp_path / "j"), ts_other)
    _assert_trees(back, js)
    assert isinstance(back["params"]["gru1"]["wz"], torch.Tensor)
    assert back["opt"]["step"].shape == () and \
        back["opt"]["step"].dtype == torch.int32
    assert sorted(os.listdir(tmp_path / "t" / "step_00000009")) == \
        sorted(os.listdir(tmp_path / "j" / "step_00000004"))


def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = {"a": np.arange(6).reshape(2, 3),
            "n": {"b": torch.full((4,), 2.5)}}
    w = t_ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (5, 10, 15):
        w.save(tree, s, extra={"step": s})
        tree["n"]["b"].add_(1.0)          # the write holds its own copy
    w.wait()
    assert t_ckpt.latest_step(str(tmp_path)) == 15
    assert len(os.listdir(tmp_path)) == 2              # gc keeps 2
    back, extra = t_ckpt.restore(str(tmp_path), tree)
    assert extra["step"] == 15
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert torch.equal(back["n"]["b"], torch.full((4,), 4.5))
    assert [(r["step"], r["bytes"]) for r in w.writes] == [
        (5, 64), (10, 64), (15, 64)] and t_ckpt.tree_bytes(tree) == 64


def test_failover_bit_exact_restart(tmp_path):
    """Preempted + restarted run must equal the uninterrupted run."""

    def init():
        return {"w": np.zeros(3), "rngsum": np.zeros(())}

    def step(s, i):
        rng = np.random.default_rng(i)      # data is a pure fn of step
        return ({"w": s["w"] + rng.normal(size=3),
                 "rngsum": s["rngsum"] + i}, {})

    clean = t_failover.run_resilient(init_state=init, train_step=step,
                                     total_steps=25,
                                     ckpt_dir=str(tmp_path / "a"),
                                     ckpt_every=5)
    faulty = t_failover.run_resilient(
        init_state=init, train_step=step, total_steps=25,
        ckpt_dir=str(tmp_path / "b"), ckpt_every=5,
        fault_plan=t_failover.FaultPlan(preempt_at_steps=(7, 18)))
    assert faulty.restarts == 2
    np.testing.assert_array_equal(clean.state["w"], faulty.state["w"])


def _cli(main, argv, monkeypatch=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if monkeypatch is None:
            main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["train", *argv])
            main()
    return out.getvalue().splitlines()


def _losses(line):
    return [float(f.split("=")[1]) for f in line.split()[1:]]


@pytest.mark.parametrize("arch", ["wide-deep", "bst"])
def test_cli_prints_the_jax_lines_and_restarts_bit_exactly(
        arch, tmp_path, monkeypatch):
    argv = ["--arch", arch, "--steps", "6", "--preempt-at", "3"]
    got = _cli(t_train.main, [*argv, "--device", "cpu", "--ckpt-dir",
                              str(tmp_path / "t")])
    want = _cli(j_train.main, [*argv, "--ckpt-dir", str(tmp_path / "j")],
                monkeypatch)[-2:]
    assert got[0] == want[0] == f"arch={arch} steps=6 restarts=1 " \
        "stragglers=0"
    np.testing.assert_allclose(_losses(got[1]), _losses(want[1]), atol=1e-4)
    assert [ln.split()[1] for ln in got[2:4]] == ["step=3", "step=6"]
    assert got[-1].startswith("report: ")
    _cli(t_train.main, ["--arch", arch, "--steps", "6", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path / "clean")])
    like = t_ckpt.restore(str(tmp_path / "clean"), _state(arch, 0)[1])[0]
    back = t_ckpt.restore(str(tmp_path / "t"), _state(arch, 0)[1])[0]
    for (name, a), b in zip(_named(like).items(), _named(back).values()):
        assert a.numpy().tobytes() == b.numpy().tobytes(), name


def test_cli_defaults_to_cuda_and_leaves_the_lm_archs_to_item_7(
        monkeypatch, tmp_path):
    # the LM archs train (ROADMAP item 7c, done): on the CPU when asked
    lines = _cli(t_train.main, ["--arch", "qwen3-4b", "--device", "cpu",
                                "--steps", "2", "--seq-len", "32",
                                "--ckpt-dir", str(tmp_path / "lm")])
    assert lines[0] == "arch=qwen3-4b steps=2 restarts=0 stragglers=0"
    assert lines[1].startswith("loss: first=")
    assert lines[-1].startswith("report: ")
    # the GNN trains through its driver, as the JAX CLI says
    with pytest.raises(SystemExit, match="use python -m "
                       "repro_torch.examples.gnn_sage for graphsage-reddit"):
        t_train.main(["--arch", "graphsage-reddit", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # by default on the card: without one the LM archs raise
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train.main(["--arch", "qwen3-4b", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train.main(["--ckpt-dir", str(tmp_path)])  # the default arch
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train.main(["--arch", "bst", "--ckpt-dir", str(tmp_path)])
    for init in (t_wd.init_wide_deep, t_dien.init_dien, t_mind.init_mind):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init(t_cfgbase.get("mind").smoke_config()
                 if init is t_mind.init_mind else
                 _cfgs("dien" if init is t_dien.init_dien
                       else "wide-deep")[1])


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window", [
    (3, 21, 8, 8, 4, False, None),      # BST's training attention
    (2, 21, 8, 2, 4, False, None),      # GQA
    (2, 19, 4, 2, 8, True, None),
    (2, 19, 4, 1, 8, True, 5),
])
def test_flash_backward_matches_autograd_and_jax(b, s, hq, hkv, hd, causal,
                                                 window):
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32)
               for h in (hq, hkv, hkv))
    w = rng.normal(size=(b, s, hq, hd)).astype(np.float32)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    wt = torch.from_numpy(w)
    out = t_attn.chunked_attention(*xs, causal=causal, window=window)
    assert out.grad_fn is not None and "FlashAttention" in \
        type(out.grad_fn).__name__
    got = torch.autograd.grad((out * wt).sum(), xs)
    ys = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    plain = torch.autograd.grad(
        (attention_ref_bshd(*ys, causal=causal, window=window) * wt).sum(),
        ys)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(j_attn.chunked_attention(
        q, k, v, causal=causal, window=window, block_q=8) * w),
        argnums=(0, 1, 2)))(q, k, v)
    for g, p, j in zip(got, plain, want):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    plain_route = t_attn.chunked_attention(*ys, causal=causal, window=window,
                                           use_kernel=False)
    np.testing.assert_allclose(plain_route.detach().numpy(),
                               out.detach().numpy(), rtol=1e-6, atol=1e-6)


def _kernel_calls():
    q = torch.randn(2, 5, 2, 4)
    docs = torch.zeros((2, 8), dtype=torch.int32)
    rho = torch.full((2,), 8, dtype=torch.int32)
    seg = torch.zeros((2, 1), dtype=torch.int32)
    return {
        "flash_attention_bshd": (lambda x: fa_kernel.flash_attention_bshd(
            x, q, q, causal=False), q.clone()),
        "flash_attention_fwd": (lambda x: fa_kernel.flash_attention_fwd(
            x, x, x), torch.randn(4, 5, 4)),
        "embedding_bag": (lambda x: eb_kernel.embedding_bag_kernel(
            x, torch.zeros((2, 3), dtype=torch.int32)), torch.randn(6, 4)),
        "impact_scan": (lambda x: is_kernel.impact_scan(
            docs, x, rho, seg, seg, n_docs=10), torch.ones((2, 8))),
        "topk": (lambda x: tk_kernel.block_topk(x, kp=2),
                 torch.randn(2, 16)),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_wrappers_refuse_inputs_that_need_a_gradient(name):
    call, x = _kernel_calls()[name]
    call(x)                                  # no grad needed: runs
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        call(x)
    with torch.no_grad():
        call(x)
    call(x.detach())


def test_gather_rows_backward_is_the_plain_gradient_and_repeats(
        monkeypatch):
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 50, (40, 7)))
    ids[:, 3:] = 0                          # a hot row, as padding makes
    w = torch.from_numpy(rng.normal(size=(40, 7, 3)).astype(np.float32))
    grads = []
    for gather in (t_emb.gather_rows, lambda t, i: t[i]):
        t = table.clone().requires_grad_(True)
        out = gather(t, ids)
        grads.append(torch.autograd.grad((out * w).sum(), t)[0])
        assert out.shape == (40, 7, 3)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               rtol=1e-6, atol=1e-6)
    rows, flat = (w * 1.5).reshape(-1, 3), ids.reshape(-1)
    a, b = (t_emb.scatter_rows(rows, flat, 50) for _ in range(2))
    assert torch.equal(a, b)
    monkeypatch.setattr(t_layers, "SCATTER_CHUNK", 4)   # runs in chunks
    rows = rows.double()
    np.testing.assert_allclose(
        t_emb.scatter_rows(rows, flat, 50).numpy(),
        torch.zeros((50, 3), dtype=torch.float64).index_add_(
            0, flat, rows).numpy(), rtol=1e-12, atol=1e-12)
    assert torch.equal(t_emb.scatter_rows(rows[:0], flat[:0], 4),
                       torch.zeros((4, 3)))
