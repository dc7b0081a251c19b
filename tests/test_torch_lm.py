"""The port's LM serving path against the JAX package on the CPU: the
parameter draw (all five LM archs), the layers, decode attention, the
MoE FFN, prefill and greedy decode for the four GQA archs at smoke size
(deepseek's MLA serving is in ``test_torch_mla.py``), the token
pipeline, the shapes and model FLOPs, and ``convert.lm_from_numpy``.

Inputs come from seeded numpy (``np.random.default_rng``) or the LM
token pipeline, and go through both packages as numpy arrays.

Tolerances, with their reasons:
  * ``init_params``: bit-equal in float32 and bfloat16 (the same numpy
    stream; float32 rounded to bfloat16 to nearest even in both).
  * float32 layers, decode attention, MoE, prefill and decode logits:
    rtol = atol = 2e-5.  The products, softmax sums and rotations add in
    another order in torch than in XLA; the smoke configs' logits (up to
    ~4 in magnitude) differ by at most ~4e-6.
  * bfloat16 layers: one bfloat16 rounding (2^-8 relative) of the same
    float32 value may land on either side, so 2^-7 relative.
  * bfloat16 prefill logits of a carried tree: 2^-3 absolute (logits up
    to ~4): the JAX attention rounds its scores and probabilities to
    bfloat16, the port's plain attention keeps them in float32.
  * bfloat16 serving (prefill and 8 decode steps fed the JAX tokens, the
    four archs' smoke configs at S 24 and 37): ``BF16_LOGIT_ATOL`` =
    6.25e-2 absolute, ``chip_smoke.py``'s ``LM_ATOL`` (two bfloat16 steps
    at |logit| in [4, 8); logits reach ~4.3).  Besides the attention's
    rounding above, the two packages round the bfloat16 residual stream
    at other places; the largest gap over these cases is 5.81e-2
    (tinyllama, S 37, prefill).  Greedy tokens equal wherever the JAX
    top-2 margin exceeds that tolerance.
  * greedy tokens: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_cfgbase
from repro.configs import lm_common as j_lm_common
from repro.data import lm_pipeline as j_pipe
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro_torch import convert
from repro_torch.configs import base as t_cfgbase
from repro_torch.configs import lm_common as t_lm_common
from repro_torch.data import lm_pipeline as t_pipe
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.tree import leaves_with_paths

ARCHS = t_cfgbase.LM_ARCHS
#: the four archs of grouped-query attention (deepseek's MLA is the fifth)
GQA_ARCHS = ARCHS[:4]
TOL = dict(rtol=2e-5, atol=2e-5)
DECODE_STEPS = 8
BF16_LOGIT_ATOL = 6.25e-2


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_cfgbase.get(arch).smoke_config(), **kw),
            dataclasses.replace(t_cfgbase.get(arch).smoke_config(), **kw))


def _jax_leaves(tree) -> dict:
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bits(a) -> np.ndarray:
    """A float32 or bfloat16 array's (or tensor's) raw bits."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16).numpy() if a.dtype == torch.bfloat16
             else a.numpy())
    return np.ascontiguousarray(a).view(
        np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


# ------------------------------------------------------------- init --

@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("tinyllama-1.1b", "bfloat16")])
def test_init_params_bit_equal_to_jax(arch, dtype):
    jc, tc = _cfgs(arch, dtype=dtype)
    want = _jax_leaves(j_tf.init_params(jc, seed=5))
    got = {tuple(map(str, p)): v for p, v in leaves_with_paths(
        t_tf.init_params(tc, seed=5, device="cpu"))}
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[-1] == w.dtype.name, name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(name))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_jax(arch):
    jc = j_cfgbase.get(arch).model_config()
    tc = t_cfgbase.get(arch).model_config()
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()


def test_lm_configs_copy_the_jax_numbers():
    for arch in ARCHS:
        j_mod, t_mod = j_cfgbase.get(arch), t_cfgbase.get(arch)
        assert (t_mod.ARCH, t_mod.SHAPES, t_mod.SKIPS) == \
            (j_mod.ARCH, j_mod.SHAPES, j_mod.SKIPS)
        for name in ("model_config", "smoke_config"):
            jc, tc = getattr(j_mod, name)(), getattr(t_mod, name)()
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), arch
            assert tc.qk_dim == jc.qk_dim
    # deepseek (MLA, MTP, shared experts): its smoke params and caches
    # are the JAX package's
    jc, tc = _cfgs("deepseek-v3-671b")
    assert tc.attn_type == "mla" and tc.mtp and tc.moe.n_shared == 1
    want = _jax_leaves(j_tf.init_params(jc, seed=2))
    got = {tuple(map(str, p)): v for p, v in leaves_with_paths(
        t_tf.init_params(tc, seed=2, device="cpu"))}
    assert set(got) == set(want) and ("mtp", "proj") in got
    for name, w in want.items():
        np.testing.assert_array_equal(_bits(got[name]), _bits(w))
    jcache = _jax_leaves(j_tf.init_cache(jc, 3, 40))
    tcache = {tuple(map(str, p)): v for p, v in leaves_with_paths(
        t_tf.init_cache(tc, 3, 40, device="cpu"))}
    assert set(tcache) == set(jcache)
    for name, w in jcache.items():
        assert tuple(tcache[name].shape) == w.shape, name
        np.testing.assert_array_equal(tcache[name].numpy(), w)


def test_lm_shapes_and_model_flops_equal_jax():
    assert t_lm_common.LM_SHAPES == j_lm_common.LM_SHAPES
    for arch in ARCHS:
        jc = j_cfgbase.get(arch).model_config()
        tc = t_cfgbase.get(arch).model_config()
        for shape in t_lm_common.LM_SHAPES.values():
            args = (shape["kind"], shape["batch"], shape["seq_len"])
            assert t_lm_common.model_flops(tc, *args) == \
                j_lm_common.model_flops(jc, *args)


# ----------------------------------------------------------- layers --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_equal_jax(dtype):
    r = np.random.default_rng(7)
    x = r.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = r.normal(size=(16,)).astype(np.float32)
    pos = r.integers(0, 5000, size=(2, 5)).astype(np.int32)
    mats = [r.normal(size=s).astype(np.float32) * 0.25
            for s in ((16, 24), (16, 24), (24, 16))]
    jdt, tdt = jnp.dtype(dtype), t_layers.torch_dtype(dtype)
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)

    def both(jfn, tfn, *arrays):
        j = jfn(*(jnp.asarray(a).astype(jdt) if a.dtype == np.float32
                  else jnp.asarray(a) for a in arrays))
        t = tfn(*(_t(a).to(tdt) if a.dtype == np.float32 else _t(a)
                  for a in arrays))
        assert t.dtype == tdt
        _close(t, np.asarray(j.astype(jnp.float32)), **tol)

    both(j_layers.rms_norm, t_layers.rms_norm, w, x)
    both(lambda a, p: j_layers.rope(a, p, 1e6),
         lambda a, p: t_layers.rope(a, p, 1e6), x, pos)
    both(j_layers.swiglu, t_layers.swiglu, *mats, x)
    both(j_layers.dense, t_layers.dense, mats[0], x)


def _ring_valid(s, pos, window):
    slot = pos % s
    stored = t_tf._slot_positions(s, _t(slot), _t(pos)).numpy()
    want = np.asarray(j_tf._slot_positions(s, jnp.asarray(slot),
                                           jnp.asarray(pos)))
    np.testing.assert_array_equal(stored, want)
    ages = pos[:, None] - stored
    return (stored >= 0) & (ages < (window or 10 ** 9))


@pytest.mark.parametrize("b,s,hq,hkv,hd,pos,window,dtype", [
    (3, 12, 8, 2, 8, (11, 4, 0), None, "float32"),     # a linear cache
    (2, 16, 8, 2, 8, (39, 9), 16, "float32"),          # wrapped; filling
    (2, 16, 4, 4, 16, (20, 7), 9, "float32"),          # window < ring
    (2, 32, 8, 1, 16, (40, 3), 32, "bfloat16"),
])
def test_decode_attention_equals_jax(b, s, hq, hkv, hd, pos, window, dtype):
    r = np.random.default_rng(b + s + hq)
    q = r.normal(size=(b, 1, hq, hd)).astype(np.float32)
    k, v = (r.normal(size=(b, s, hkv, hd)).astype(np.float32)
            for _ in range(2))
    valid = _ring_valid(s, np.asarray(pos), window)
    assert not valid[-1].all()                  # a row with masked slots
    jdt, tdt = jnp.dtype(dtype), t_layers.torch_dtype(dtype)
    want = j_attn.decode_attention(*(jnp.asarray(a).astype(jdt)
                                     for a in (q, k, v)), jnp.asarray(valid))
    got = t_attn.decode_attention(*(_t(a).to(tdt) for a in (q, k, v)),
                                  _t(valid))
    assert got.dtype == tdt and got.shape == (b, 1, hq, hd)
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    _close(got, np.asarray(want.astype(jnp.float32)), **tol)


def _moe_case(cf, router_scale=1.0, seed=0):
    r = np.random.default_rng(seed)
    p = {"router": r.normal(size=(24, 4)).astype(np.float32) * router_scale,
         **{n: r.normal(size=s).astype(np.float32) * 0.2
            for n, s in (("w_gate", (4, 24, 16)), ("w_up", (4, 24, 16)),
                         ("w_down", (4, 16, 24)))}}
    x = r.normal(size=(40, 24)).astype(np.float32)
    kw = dict(n_experts=4, top_k=2, d_ff_expert=16, capacity_factor=cf)
    jy, jaux = j_moe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), j_moe.MoEConfig(**kw))
    ty, taux = t_moe.moe_ffn({k: _t(v) for k, v in p.items()}, _t(x),
                             t_moe.MoEConfig(**kw))
    return np.asarray(jy), float(jaux), ty, float(taux)


def test_moe_ffn_drops_the_tokens_jax_drops():
    # capacity 16 of 40 tokens x top-2 over 4 experts: tokens are dropped
    kw = dict(n_experts=4, top_k=2, d_ff_expert=16, capacity_factor=0.5)
    assert t_moe._capacity(40, t_moe.MoEConfig(**kw)) == \
        j_moe._capacity(40, j_moe.MoEConfig(**kw)) == 16
    jy, jaux, ty, taux = _moe_case(0.5)
    _close(ty, jy)
    assert taux == pytest.approx(jaux, rel=1e-6)
    _, _, full, _ = _moe_case(4.0)
    dropped = (full - ty).abs().amax(dim=1) > 1e-3
    assert 0 < int(dropped.sum()) < 40


def test_moe_ffn_ties_route_to_the_lower_expert():
    # a zero router: every expert ties, top-2 is experts 0 and 1 for every
    # token, as jax.lax.top_k orders ties; capacity drops the tail
    jy, jaux, ty, taux = _moe_case(0.5, router_scale=0.0)
    _close(ty, jy)
    assert taux == pytest.approx(jaux, rel=1e-6)
    assert (ty[16:] == 0).all() and (ty[:16] != 0).any()


# ----------------------------------------------------- prefill/decode --

def _prompt(vocab, s, batch=2):
    return t_pipe.LMPipeline(t_pipe.LMDataConfig(
        vocab=vocab, batch=batch, seq_len=s, seed=1)).batch(0)["tokens"]


def _handoff(cache, pre, put):
    """The prefill's keys and values into slots [0, clen) of ``cache``."""
    for g in pre:
        for x in pre[g]:
            put(cache[g], x, pre[g][x])


def _jax_serve(jc, toks):
    jp = j_tf.init_params(jc, seed=0)
    logits, pre = j_tf.prefill(jp, jc, jnp.asarray(toks))
    cache = j_tf.init_cache(jc, toks.shape[0], toks.shape[1] + DECODE_STEPS)

    def put(c, x, v):
        c[x] = c[x].at[:, :, :v.shape[2]].set(v)

    _handoff(cache, pre, put)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    steps = []
    for i in range(DECODE_STEPS):
        pos = jnp.full((toks.shape[0],), toks.shape[1] + i, jnp.int32)
        tok, lg, cache = j_tf.decode_step(jp, jc, cache, tok, pos)
        steps.append((np.asarray(tok), np.asarray(lg)))
    return np.asarray(logits), jax.tree.map(np.asarray, pre), steps, \
        jax.tree.map(np.asarray, cache)


def _port_serve(tc, toks, device="cpu"):
    tp = t_tf.init_params(tc, seed=0, device=device)
    t_toks = _t(toks).to(device)
    logits, pre = t_tf.prefill(tp, tc, t_toks)
    cache = t_tf.init_cache(tc, toks.shape[0], toks.shape[1] + DECODE_STEPS,
                            device=device)

    def put(c, x, v):
        c[x][:, :, :v.shape[2]] = v

    _handoff(cache, pre, put)
    tok = torch.argmax(logits, -1).to(torch.int32)
    steps = []
    for i in range(DECODE_STEPS):
        pos = torch.full((toks.shape[0],), toks.shape[1] + i,
                         dtype=torch.int32, device=device)
        tok, lg, cache = t_tf.decode_step(tp, tc, cache, tok, pos)
        steps.append((tok.cpu().clone(), lg.cpu().clone()))
    return logits, pre, steps, cache


@pytest.mark.parametrize("arch,s", [(a, 24) for a in ARCHS[:3]]
                         + [("mixtral-8x22b", 32), ("mixtral-8x22b", 12),
                            ("mixtral-8x22b", 20)])
def test_prefill_and_decode_equal_jax(arch, s):
    # mixtral: S a multiple of its window of 16, S below it, and S = 20,
    # where the reference's handoff leaves slots out of ring order (the
    # port reproduces it); deepseek's MLA cases are in test_torch_mla.py
    jc, tc = _cfgs(arch)
    toks = _prompt(tc.vocab, s)
    j_logits, j_pre, j_steps, j_cache = _jax_serve(jc, toks)
    t_logits, t_pre, t_steps, t_cache = _port_serve(tc, toks)
    assert t_logits.dtype == torch.float32
    _close(t_logits, j_logits)
    for g in j_pre:
        assert set(t_pre[g]) == set(j_pre[g])
        for x in j_pre[g]:
            assert tuple(t_pre[g][x].shape) == j_pre[g][x].shape
            _close(t_pre[g][x], j_pre[g][x])
            _close(t_cache[g][x], j_cache[g][x])
    for (jt, jl), (tt, tl) in zip(j_steps, t_steps):
        np.testing.assert_array_equal(tt.numpy(), jt)
        _close(tl, jl)


def _hold_bf16_logits(got: torch.Tensor, want, what):
    """got within BF16_LOGIT_ATOL of want ((B, V)), and its greedy token
    equal wherever want's top-2 margin exceeds the tolerance."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    err = float(np.abs(got - want).max())
    assert err <= BF16_LOGIT_ATOL, (what, err)
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > BF16_LOGIT_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[decided],
                                  want.argmax(-1)[decided], err_msg=what)


@pytest.mark.parametrize("arch,s", [(a, s) for a in GQA_ARCHS
                                    for s in (24, 37)])
def test_bf16_serving_equals_jax(arch, s):
    # each package serves its own prefill and cache; every decode step
    # gets the token the JAX package chose, so one near-tie cannot send
    # the two down different sequences
    jc, tc = _cfgs(arch, dtype="bfloat16")
    toks = _prompt(tc.vocab, s)
    jp = j_tf.init_params(jc, seed=0)
    tp = t_tf.init_params(tc, seed=0, device="cpu")
    j_logits, j_pre = j_tf.prefill(jp, jc, jnp.asarray(toks))
    t_logits, t_pre = t_tf.prefill(tp, tc, _t(toks))
    assert t_logits.dtype == torch.float32
    _hold_bf16_logits(t_logits, j_logits, "prefill")
    j_cache = j_tf.init_cache(jc, toks.shape[0], s + DECODE_STEPS)
    t_cache = t_tf.init_cache(tc, toks.shape[0], s + DECODE_STEPS,
                              device="cpu")

    def j_put(c, x, v):
        c[x] = c[x].at[:, :, :v.shape[2]].set(v)

    def t_put(c, x, v):
        c[x][:, :, :v.shape[2]] = v

    _handoff(j_cache, j_pre, j_put)
    _handoff(t_cache, t_pre, t_put)
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
    for i in range(DECODE_STEPS):
        pos = np.full((toks.shape[0],), s + i, np.int32)
        j_tok, j_lg, j_cache = j_tf.decode_step(
            jp, jc, j_cache, jnp.asarray(tok), jnp.asarray(pos))
        _, t_lg, t_cache = t_tf.decode_step(tp, tc, t_cache, _t(tok),
                                            _t(pos))
        _hold_bf16_logits(t_lg, j_lg, f"decode step {i + 1}")
        tok = np.array(j_tok)


def test_backbone_equals_jax():
    # mixtral's smoke config: the hidden states and the MoE aux loss
    jc, tc = _cfgs("mixtral-8x22b")
    toks = _prompt(tc.vocab, 24)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32)[None], toks.shape)
    jh, jaux = j_tf.backbone(j_tf.init_params(jc, seed=0), jc,
                             jnp.asarray(toks), jnp.asarray(pos))
    th, taux = t_tf.backbone(t_tf.init_params(tc, seed=0, device="cpu"),
                             tc, _t(toks), _t(pos))
    _close(th, np.asarray(jh))
    assert float(taux) > 0
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)


@pytest.mark.parametrize("s", [12, 32])
def test_sliding_window_decode_matches_a_longer_prefill(s):
    # where S <= window or S % window == 0 the ring holds the prompt's
    # keys in order, and a decode step equals the prefill of S + 1.  A
    # dense model with mixtral's window: MoE capacity drops depend on
    # the number of tokens routed together, which differ between the two
    _, tc = _cfgs("tinyllama-1.1b", window=16)
    toks = _prompt(tc.vocab, s)
    logits, _, steps, _ = _port_serve(tc, toks)
    first = torch.argmax(logits, -1).numpy().astype(np.int32)
    longer = np.concatenate([toks, first[:, None]], axis=1)
    tp = t_tf.init_params(tc, seed=0, device="cpu")
    want = t_tf.prefill(tp, tc, _t(longer))[0]
    _close(steps[0][1], want.numpy())


def test_decode_step_writes_the_cache_in_place():
    _, tc = _cfgs("tinyllama-1.1b")
    tp = t_tf.init_params(tc, seed=0, device="cpu")
    cache = t_tf.init_cache(tc, 2, 8, device="cpu")
    k = cache["dense"]["k"]
    tok = torch.tensor([3, 4], dtype=torch.int32)
    _, _, out = t_tf.decode_step(tp, tc, cache, tok, torch.tensor([0, 5]))
    assert out["dense"]["k"] is k
    assert (k[:, 0, 0] != 0).any() and (k[:, 1, 5] != 0).any()
    assert (k[:, 0, 1:] == 0).all() and (k[:, 1, :5] == 0).all()


# -------------------------------------------------- pipeline, convert --

@pytest.mark.parametrize("kw", [dict(vocab=512, batch=3, seq_len=37, seed=2),
                                dict(vocab=32000, batch=2, seq_len=64,
                                     seed=1, n_hosts=2, host_id=1)])
def test_lm_pipeline_batches_bit_equal(kw):
    jp = j_pipe.LMPipeline(j_pipe.LMDataConfig(**kw))
    tp = t_pipe.LMPipeline(t_pipe.LMDataConfig(**kw))
    for step in (0, 5):
        jb, tb = jp.batch(step), tp.batch(step)
        assert set(jb) == set(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
    pf = t_pipe.Prefetcher(tp.batch, depth=2, start_step=3)
    try:
        step, b = pf.next()
        assert step == 3
        np.testing.assert_array_equal(b["tokens"], jp.batch(3)["tokens"])
    finally:
        pf.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_from_numpy_gives_the_jax_logits(dtype):
    jc, tc = _cfgs("qwen3-4b", dtype=dtype)
    jp = j_tf.init_params(jc, seed=3)
    tp = convert.lm_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    got = {tuple(map(str, p)): v for p, v in leaves_with_paths(tp)}
    for name, w in _jax_leaves(jp).items():
        np.testing.assert_array_equal(_bits(got[name]), _bits(w))
    toks = _prompt(tc.vocab, 24)
    want = np.asarray(j_tf.prefill(jp, jc, jnp.asarray(toks))[0])
    tol = TOL if dtype == "float32" else dict(rtol=0, atol=2 ** -3)
    _close(t_tf.prefill(tp, tc, _t(toks))[0], want, **tol)
    with pytest.raises(ValueError, match="keys"):
        convert.lm_from_numpy({"embed": np.zeros((2, 2), np.float32)},
                              device="cpu")
