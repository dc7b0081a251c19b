"""LM training of the port against the JAX package on the CPU:
``layers.chunked_softmax_xent`` and ``transformer.train_loss`` (values
and gradients, against ``jax.value_and_grad``) at the five LM archs'
smoke configs, and flash_attention's backward by query block against the
whole-matrix backward and against autograd of the plain attention.

Inputs are seeded numpy draws or the LM token pipeline, passed to both
packages as numpy arrays; the JAX side is jitted.

Tolerances, with their reasons:
  * losses: rtol = atol = 2e-5 (float32; the block sums and products add
    in another order in torch than in XLA; the gap seen is <= 1e-6).
  * gradients: each leaf within 2e-5 of its largest |gradient|
    (absolute): float32 sums of the backward in another order, and the
    reference's checkpointed scan against the port's checkpointed loop;
    the largest gap seen is 3.6e-6 of a leaf's largest gradient.
  * blocked flash backward against the whole-matrix one and against
    autograd of the oracle: 2e-5 absolute on gradients of O(1) (float32
    sums over the key blocks in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_cfgbase
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro_torch.configs import base as t_cfgbase
from repro_torch.data import lm_pipeline as t_pipe
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref_bshd
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf
from repro_torch.tree import leaves_with_paths

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_REL = 2e-5


def _jax_grads(tree) -> dict:
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _hold_grads(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=GRAD_REL * scale,
                                   err_msg=str(name))


def test_chunked_softmax_xent_equals_jax():
    r = np.random.default_rng(4)
    t, d, v = 96, 16, 50
    h = r.normal(size=(t, d)).astype(np.float32)
    w = (r.normal(size=(d, v)) * 0.3).astype(np.float32)
    tg = r.integers(0, v, t).astype(np.int32)
    mk = (r.random(t) > 0.2).astype(np.float32)
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda a, b: j_layers.chunked_softmax_xent(
            a, b, jnp.asarray(tg), jnp.asarray(mk), block=32),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl = t_layers.chunked_softmax_xent(th, tw, torch.from_numpy(tg),
                                       torch.from_numpy(mk), block=32)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), **TOL)
    # no grad: the same value, blocks run without checkpoints
    with torch.no_grad():
        again = t_layers.chunked_softmax_xent(
            th, tw, torch.from_numpy(tg), torch.from_numpy(mk), block=32)
    assert float(again) == float(tl.detach())
    with pytest.raises(ValueError, match="divisible"):
        t_layers.chunked_softmax_xent(th, tw, torch.from_numpy(tg),
                                      torch.from_numpy(mk), block=40)


@pytest.mark.parametrize("arch", t_cfgbase.LM_ARCHS)
def test_train_loss_and_grads_equal_jax(arch):
    """tinyllama; qwen2 (QKV bias); qwen3 (qk-norm); mixtral (window 16
    below S = 64, MoE aux); deepseek (MLA, shared experts, MTP)."""
    jc = j_cfgbase.get(arch).smoke_config()
    tc = t_cfgbase.get(arch).smoke_config()
    batch = t_pipe.LMPipeline(t_pipe.LMDataConfig(
        vocab=tc.vocab, batch=2, seq_len=64, seed=1)).batch(0)
    batch["mask"][1, 50:] = 0
    jl, jg = jax.jit(jax.value_and_grad(lambda p: j_tf.train_loss(
        p, jc, *(jnp.asarray(batch[k])
                 for k in ("tokens", "targets", "mask")))))(
        j_tf.init_params(jc, seed=0))
    tp = t_tf.init_params(tc, seed=0, device="cpu")
    named = [(tuple(map(str, p)), v) for p, v in leaves_with_paths(tp)]
    for _, v in named:
        v.requires_grad_(True)
    tl = t_tf.train_loss(tp, tc, *(torch.from_numpy(batch[k])
                                   for k in ("tokens", "targets", "mask")))
    grads = torch.autograd.grad(tl, [v for _, v in named])
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    _hold_grads({n: g.numpy() for (n, _), g in zip(named, grads)},
                _jax_grads(jg))


def _qkvo(b, s, hq, hkv, hd, seed):
    r = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(r.normal(size=(b, s, h, hd)).astype(
        np.float32)) for h in (hq, hkv, hkv, hq))
    return q, k, v, do


@pytest.mark.parametrize("s,hq,hkv,causal,window,block_q", [
    (40, 4, 4, True, None, 16),      # causal, S not a multiple of bq
    (40, 6, 2, True, None, 16),      # GQA g = 3
    (37, 8, 2, True, 9, 8),          # window inside a block's reach
    (33, 4, 1, False, None, 16),     # non-causal, g = 4
    (21, 8, 8, False, None, 512),    # BST's one block (S = 21)
    (30, 2, 1, False, 7, 8),         # a window without causality
])
def test_blocked_backward_matches_whole_matrix_and_autograd(
        s, hq, hkv, causal, window, block_q):
    q, k, v, do = _qkvo(2, s, hq, hkv, 8, seed=s + hq)
    o = attention_ref_bshd(q, k, v, causal=causal, window=window)
    got = fa_ops.flash_attention_bwd_blocked(q, k, v, o, do, causal=causal,
                                             window=window, block_q=block_q)
    whole = fa_ops.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                       window=window)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = torch.autograd.grad(attention_ref_bshd(
        *leaves, causal=causal, window=window), leaves, do)
    for g, w, a, x in zip(got, whole, ref, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5)
        torch.testing.assert_close(g, a, rtol=0, atol=2e-5)


def test_flash_attention_function_runs_the_blocked_backward(monkeypatch):
    """Through autograd, ``ops.flash_attention`` on the kernel route
    (its plain version on CPU tensors) calls the blocked backward with
    the layer's ``block_q`` and gives autograd-of-the-oracle's grads."""
    q, k, v, do = _qkvo(2, 50, 4, 2, 8, seed=1)
    calls = []
    real = fa_ops.flash_attention_bwd_blocked

    def spy(*a, **kw):
        calls.append(kw["block_q"])
        return real(*a, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention_bwd_blocked", spy)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(fa_ops.flash_attention(
        *leaves, causal=True, block_q=16), leaves, do)
    assert calls == [16]
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref_bshd(*ref_leaves, causal=True),
                               ref_leaves, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5)


def test_block_key_range_covers_every_live_key():
    s = 23
    for causal, window in ((True, None), (True, 5), (False, None),
                           (False, 6)):
        for q0 in range(0, s, 4):
            q1 = min(q0 + 4, s)
            k0, k1 = fa_ops.block_key_range(q0, q1, s, causal, window)
            for qi in range(q0, q1):
                live = [kj for kj in range(s)
                        if (not causal or kj <= qi)
                        and (window is None or qi - kj < window)]
                assert k0 <= min(live) and max(live) < k1
