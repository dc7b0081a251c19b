"""deepseek-v3-671b's MLA and MTP in the port against the JAX package on
the CPU, at its smoke config: prefill (the latent cache of ``c_kv`` and
the rotated rope key) and greedy decode through the absorbed-matmul
latent attention over a cache longer than the prompt, and
``chunked_attention``'s plain path for a value head dim other than the
query head dim.

Tolerances, with their reasons:
  * float32 logits, caches and attention outputs: rtol = atol = 2e-5
    (the products, softmax sums and rotations add in another order in
    torch than in XLA).
  * bfloat16 attention outputs: 2^-6 absolute on outputs of O(1): both
    keep the reference's rounding points (scores rounded to bfloat16,
    probabilities cast to bfloat16 before the product), and a rounding
    of the same float32 value may land one bfloat16 step apart.
  * greedy tokens: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn
from repro.models import transformer as j_tf
from repro_torch import convert
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as t_tf
from repro_torch.tree import leaves_with_paths

from test_torch_lm import (_bits, _cfgs, _close, _jax_leaves, _jax_serve,
                           _port_serve, _prompt, _t)


@pytest.mark.parametrize("s", [24, 37])
def test_mla_prefill_and_decode_equal_jax(s):
    jc, tc = _cfgs("deepseek-v3-671b")
    toks = _prompt(tc.vocab, s)
    j_logits, j_pre, j_steps, j_cache = _jax_serve(jc, toks)
    t_logits, t_pre, t_steps, t_cache = _port_serve(tc, toks)
    _close(t_logits, j_logits)
    for g in j_pre:
        assert set(t_pre[g]) == set(j_pre[g]) == {"c_kv", "k_rope"}
        for x in j_pre[g]:
            assert tuple(t_pre[g][x].shape) == j_pre[g][x].shape
            _close(t_pre[g][x], j_pre[g][x])
            assert t_cache[g][x].shape[2] == s + len(j_steps)
            _close(t_cache[g][x], j_cache[g][x])
    for (jt, jl), (tt, tl) in zip(j_steps, t_steps):
        np.testing.assert_array_equal(tt.numpy(), jt)
        _close(tl, jl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,hq,hkv,causal,window,block_q", [
    (40, 4, 4, True, None, 16),      # MLA's shape: Hq = Hkv, S % bq != 0
    (37, 6, 2, True, 9, 8),          # GQA with a window
    (33, 4, 1, False, None, 16),     # non-causal
])
def test_plain_path_for_wider_query_heads_equals_jax(s, hq, hkv, causal,
                                                     window, block_q,
                                                     dtype):
    r = np.random.default_rng(s)
    q = r.normal(size=(2, s, hq, 24)).astype(np.float32)
    k = r.normal(size=(2, s, hkv, 24)).astype(np.float32)
    v = r.normal(size=(2, s, hkv, 16)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(j_attn.chunked_attention(
        *(jnp.asarray(x, jd) for x in (q, k, v)), causal=causal,
        window=window, block_q=block_q).astype(jnp.float32))
    before = fa_kernel.n_launches
    got = t_attn.chunked_attention(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), causal=causal,
        window=window, block_q=block_q)
    assert fa_kernel.n_launches == before          # not the kernel
    assert got.shape == (2, s, hq, 16) and got.dtype == td
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == "float32"
           else dict(rtol=0, atol=2 ** -6))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_plain_path_under_grad_saves_no_scores():
    """Under autograd the plain path checkpoints each query block, so it
    saves no block's scores or probabilities for backward.  A layer
    checkpointed under ``remat="full"`` runs it under grad again in its
    recompute; without the block checkpoints that recompute would save
    every block's float32 P, (B, H, S, S) / 2 in all."""
    b, s, hq, bq = 2, 40, 4, 10        # key counts 10-40, head dims 24, 16
    r = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(r.normal(size=(b, s, hq, d))
                                .astype(np.float32)).requires_grad_(True)
               for d in (24, 24, 16))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = t_attn.chunked_attention(q, k, v, causal=True, block_q=bq)
    # only each block's inputs (q, k, v slices and its bool mask)
    floats = [t for t in saved if t.is_floating_point()]
    assert len(floats) == 3 * (s // bq)
    assert all(t.shape[-1] in (24, 16) for t in floats)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    want = torch.autograd.grad(t_attn._plain_blocked(
        q, k, v, causal=True, window=None, block_q=s).sum(), (q, k, v))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


def test_mla_params_cross_through_lm_from_numpy():
    """A JAX-drawn deepseek tree (MLA, MoE with a shared expert, MTP)
    carried bit for bit; its prefill logits are the JAX package's."""
    jc, tc = _cfgs("deepseek-v3-671b")
    jp = j_tf.init_params(jc, seed=4)
    tp = convert.lm_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert "mtp" in tp and "wdkv" in tp["dense"]["attn"]
    got = {tuple(map(str, p)): v for p, v in leaves_with_paths(tp)}
    for name, w in _jax_leaves(jp).items():
        np.testing.assert_array_equal(_bits(got[name]), _bits(w))
    toks = _prompt(tc.vocab, 20)
    want = np.asarray(j_tf.prefill(jp, jc, jnp.asarray(toks))[0])
    _close(t_tf.prefill(tp, tc, _t(toks))[0], want)
