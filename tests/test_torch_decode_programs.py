"""The port's decode programs (``serving/decode.py``: ``decode_step`` as
one program a batch and cache length, the parameters and the cache its
constants) against eager ``decode_step`` and against the JAX package,
on the CPU, at the LM archs' smoke configs.

On the CPU a program is the step itself (the card's CUDA graphs, and a
build in the middle of a generation there, are held in
``tests/test_torch_gpu.py``), so these tests hold the keys, the counts,
the binding of a program to its cache and the raising paths: the port
builds as many programs as ``jax.jit`` of the decode bundle's
``serve_step`` compiles on the same calls.

Tolerances: the programs' tokens and logits equal eager ``decode_step``
bit for bit (the same ops on the same inputs); against the JAX package
the tokens are equal and the float32 logits within
``test_torch_lm.py``'s 2e-5 (products and sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as j_tf
from repro_torch.models import transformer as t_tf
from repro_torch.serving.decode import DecodePrograms
from repro_torch.tree import leaves

from test_torch_lm import (DECODE_STEPS, _cfgs, _close, _jax_serve,
                           _prompt)

#: GQA (tinyllama), QKV bias (qwen2), qk-norm (qwen3), sliding window and
#: MoE with the prompt past the window of 16 (mixtral), MLA's absorbed
#: decode with MoE and a shared expert (deepseek)
CASES = [("tinyllama-1.1b", 24), ("qwen2-0.5b", 24), ("qwen3-4b", 24),
         ("mixtral-8x22b", 32), ("deepseek-v3-671b", 24)]


def _prefilled(tc, toks, params):
    """The prompt's prefill handed to a cache of S + DECODE_STEPS, and
    its greedy token."""
    logits, pre = t_tf.prefill(params, tc, torch.from_numpy(toks))
    cache = t_tf.init_cache(tc, toks.shape[0], toks.shape[1] + DECODE_STEPS,
                            device="cpu")
    for g in pre:
        for x in pre[g]:
            cache[g][x][:, :, :pre[g][x].shape[2]] = pre[g][x]
    return cache, torch.argmax(logits, -1).to(torch.int32)


def _generate(tc, toks, params, step, start=0, steps=DECODE_STEPS):
    """Greedy decode from the prefill: steps before ``start`` run eagerly
    (``decode_step``), the rest through ``step``.  Returns [(token,
    logits)] and the cache."""
    cache, tok = _prefilled(tc, toks, params)
    out = []
    for i in range(steps):
        pos = torch.full((toks.shape[0],), toks.shape[1] + i,
                         dtype=torch.int32)
        fn = step if i >= start else (
            lambda p, c, t, q: t_tf.decode_step(p, tc, c, t, q))
        tok, lg, cache = fn(params, cache, tok, pos)
        out.append((tok.clone(), lg.clone()))
    return out, cache


@pytest.mark.parametrize("arch,s", CASES)
def test_decode_programs_equal_eager_and_jax(arch, s):
    jc, tc = _cfgs(arch)
    toks = _prompt(tc.vocab, s)
    params = t_tf.init_params(tc, seed=0, device="cpu")
    progs = DecodePrograms(params, tc)
    got, cache = _generate(tc, toks, params, progs)
    want, want_cache = _generate(tc, toks, params, None,
                                 start=DECODE_STEPS)
    for (gt, gl), (wt, wl) in zip(got, want):
        assert torch.equal(gt, wt) and torch.equal(gl, wl)
    for a, b in zip(leaves(cache), leaves(want_cache)):
        assert torch.equal(a, b)
    assert progs.n_compiles == 1
    _, _, j_steps, _ = _jax_serve(jc, toks)
    for (jt, jl), (gt, gl) in zip(j_steps, got):
        np.testing.assert_array_equal(gt.numpy(), jt)
        _close(gl, jl)


def test_program_counts_equal_the_jax_jit_cache():
    """One program a (batch, cache length), as ``jax.jit(serve_step)``
    compiles one a shape: batch 2 and 3 over a cache of 30, batch 2 over
    a cache of 40, each for a few steps."""
    jc, tc = _cfgs("tinyllama-1.1b")
    jp = j_tf.init_params(jc, seed=0)
    params = t_tf.init_params(tc, seed=0, device="cpu")
    progs = DecodePrograms(params, tc)
    serve_step = jax.jit(
        lambda p, c, t, q: j_tf.decode_step(p, jc, c, t, q))
    counts, caches = [], {}
    for b, clen, steps in ((2, 30, 3), (3, 30, 2), (2, 40, 2), (2, 30, 1)):
        if (b, clen) not in caches:
            caches[b, clen] = [j_tf.init_cache(jc, b, clen),
                               t_tf.init_cache(tc, b, clen, device="cpu")]
        jcache, tcache = caches[b, clen]
        tok = np.arange(b, dtype=np.int32) + 1
        for i in range(steps):
            pos = np.full((b,), 5 + i, np.int32)
            jt, _, jcache = serve_step(jp, jcache, jnp.asarray(tok),
                                       jnp.asarray(pos))
            tt, _, _ = progs(params, tcache, torch.from_numpy(tok),
                             torch.from_numpy(pos))
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            tok = tt.numpy()
        caches[b, clen][0] = jcache
        counts.append((progs.n_compiles, serve_step._cache_size()))
    assert counts == [(1, 1), (2, 2), (3, 3), (3, 3)]
    assert progs.programs.keys()[0][0] == "decode"


def test_a_build_mid_generation_leaves_the_tokens_unchanged():
    """Four eager steps, then the programs on the same cache (the build
    runs on the fifth step's own inputs): the tokens, logits and cache
    equal an eager generation's."""
    _, tc = _cfgs("mixtral-8x22b")
    toks = _prompt(tc.vocab, 12)
    params = t_tf.init_params(tc, seed=0, device="cpu")
    progs = DecodePrograms(params, tc)
    got, cache = _generate(tc, toks, params, progs, start=4)
    want, want_cache = _generate(tc, toks, params, None,
                                 start=DECODE_STEPS)
    assert progs.n_compiles == 1
    for (gt, gl), (wt, wl) in zip(got, want):
        assert torch.equal(gt, wt) and torch.equal(gl, wl)
    for a, b in zip(leaves(cache), leaves(want_cache)):
        assert torch.equal(a, b)


def test_a_foreign_cache_or_parameter_raises():
    """A program is bound to the cache it was built on: another cache of
    the same shapes raises, as does a copy of a parameter; nothing is
    built by either call."""
    _, tc = _cfgs("qwen3-4b")
    params = t_tf.init_params(tc, seed=0, device="cpu")
    progs = DecodePrograms(params, tc)
    cache = t_tf.init_cache(tc, 2, 16, device="cpu")
    tok = torch.tensor([3, 4], dtype=torch.int32)
    pos = torch.tensor([0, 0], dtype=torch.int32)
    progs(params, cache, tok, pos)
    with pytest.raises(ValueError, match="another cache"):
        progs(params, t_tf.init_cache(tc, 2, 16, device="cpu"), tok, pos)
    copied = dict(params, lm_head=params["lm_head"].clone())
    with pytest.raises(ValueError, match="parameter"):
        progs(copied, cache, tok, pos)
    assert progs.n_compiles == 1


def test_a_failing_step_raises():
    """No fallback: a step that fails (a token batch that is not the
    cache's) raises out of its program, and nothing runs it another way;
    the next good call serves.  On the card the failure comes in the
    build, which then keeps no entry (``tests/test_torch_gpu.py``)."""
    _, tc = _cfgs("tinyllama-1.1b")
    params = t_tf.init_params(tc, seed=0, device="cpu")
    progs = DecodePrograms(params, tc)
    cache = t_tf.init_cache(tc, 2, 16, device="cpu")
    with pytest.raises(IndexError):
        progs(params, cache, torch.zeros(3, dtype=torch.int32),
              torch.zeros(3, dtype=torch.int32))
    tok, lg, out = progs(params, cache, torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32))
    assert out is cache and tok.dtype == torch.int32
    assert lg.shape == (2, tc.vocab)
