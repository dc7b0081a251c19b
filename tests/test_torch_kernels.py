"""The port's kernel modules against the JAX package's kernels.

On the CPU the port's kernel wrappers run their plain torch versions;
they are held here against the Pallas kernels in interpret mode and
against the jnp oracles.  Tolerances: exact.  Impacts are integer-valued
float32 (partial sums below 2^24), and top-k is a selection, so every
output must be bit-identical.  The CUDA kernels themselves are compared
with the plain versions on the card (tests/test_torch_gpu.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.impact_scan import kernel as j_is_kernel
from repro.kernels.impact_scan import ops as j_is_ops
from repro.kernels.topk import kernel as j_tk_kernel
from repro.kernels.topk import ops as j_tk_ops
from repro.retrieval import index as j_index
from repro_torch.kernels.impact_scan import kernel as t_is_kernel
from repro_torch.kernels.impact_scan import ops as t_is_ops
from repro_torch.kernels.impact_scan.ref import impact_scan_ref
from repro_torch.kernels.topk import kernel as t_tk_kernel
from repro_torch.kernels.topk import ops as t_tk_ops
from repro_torch.retrieval import index as t_index


def _int_streams(q, p, nd, seed=7):
    """Quantized-impact streams (integer-valued f32, like the index)."""
    r = np.random.default_rng(seed)
    docs = r.integers(-1, nd, (q, p)).astype(np.int32)
    imps = r.integers(0, 256, (q, p)).astype(np.float32)
    return docs, imps


def _rho(q, p):
    return np.array([0, 1, p // 2, p + 50, p][:q] * 2, np.int32)[:q]


# ------------------------------------------------------------ impact scan --

@pytest.mark.parametrize("q,p,nd,bp,bd,seg", [
    (4, 300, 500, 64, 128, True),
    (3, 128, 77, 32, 32, True),
    (2, 65, 40, 32, 16, False),     # ragged stream tail (65 % 32 != 0)
    (5, 256, 1000, 256, 2048, True),  # one posting block, one doc tile
    (1, 100, 77, 512, 32, False),     # block_p clamps to the stream
])
def test_impact_scan_matches_pallas_and_ref(q, p, nd, bp, bd, seg):
    docs, imps = _int_streams(q, p, nd)
    rho = _rho(q, p)
    jseg = (j_index.block_doc_bounds(jnp.asarray(docs), block_p=bp,
                                     n_docs=nd) if seg else None)
    tseg = (t_index.block_doc_bounds(torch.from_numpy(docs), block_p=bp,
                                     n_docs=nd) if seg else None)
    if seg:
        for a, b in zip(jseg, tseg):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ja, jc = j_is_ops.saat_accumulate(
        jnp.asarray(docs), jnp.asarray(imps), n_docs=nd,
        rho=jnp.asarray(rho), block_p=bp, block_d=bd, seg_bounds=jseg,
        with_stats=True, use_kernel=True, interpret=True)
    ta, tc = t_is_ops.saat_accumulate(
        torch.from_numpy(docs), torch.from_numpy(imps), n_docs=nd,
        rho=torch.from_numpy(rho), block_p=bp, block_d=bd, seg_bounds=tseg,
        with_stats=True, use_kernel=True)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # the oracle route agrees too, counts included
    oa, oc = t_is_ops.saat_accumulate(
        torch.from_numpy(docs), torch.from_numpy(imps), n_docs=nd,
        rho=torch.from_numpy(rho), block_p=bp, block_d=bd, seg_bounds=tseg,
        with_stats=True, use_kernel=False)
    np.testing.assert_array_equal(oa.numpy(), ta.numpy())
    np.testing.assert_array_equal(oc.numpy(), tc.numpy())


@pytest.mark.parametrize("rho", [0, 1, 33, 100, 1000])
def test_impact_scan_static_rho_matches_jax_ref(rho):
    from repro.kernels.impact_scan.ref import impact_scan_ref as j_ref
    docs, imps = _int_streams(3, 100, 200)
    ref = j_ref(jnp.asarray(docs), jnp.asarray(imps), n_docs=200, rho=rho)
    out = impact_scan_ref(torch.from_numpy(docs), torch.from_numpy(imps),
                          n_docs=200, rho=rho)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    via_kernel = t_is_ops.saat_accumulate(
        torch.from_numpy(docs), torch.from_numpy(imps), n_docs=200,
        rho=torch.full((3,), rho, dtype=torch.int32), block_p=32,
        block_d=64)
    np.testing.assert_array_equal(via_kernel.numpy(), np.asarray(ref))


def test_impact_scan_stats_match_live_cell_count():
    q, p, nd, bp, bd = 3, 128, 512, 32, 64
    r = np.random.default_rng(3)
    blocks = []
    for pb in range(p // bp):      # each posting block clusters in one tile
        base = (pb * 131) % (nd - bd)
        blocks.append(r.integers(base, base + bd, (q, bp)))
    docs = np.concatenate(blocks, axis=1).astype(np.int32)
    imps = r.integers(0, 256, (q, p)).astype(np.float32)
    rho = np.array([0, 50, 128], np.int32)
    tseg = t_index.block_doc_bounds(torch.from_numpy(docs), block_p=bp,
                                    n_docs=nd)
    _, cnt = t_is_ops.saat_accumulate(
        torch.from_numpy(docs), torch.from_numpy(imps), n_docs=nd,
        rho=torch.from_numpy(rho), block_p=bp, block_d=bd, seg_bounds=tseg,
        with_stats=True)
    analytic = int(j_is_kernel.live_cell_count(
        jnp.asarray(rho), jnp.asarray(tseg[0].numpy()),
        jnp.asarray(tseg[1].numpy()), p=p, n_docs=nd, block_p=bp,
        block_d=bd))
    assert int(cnt.sum()) == analytic
    assert int(t_is_kernel.live_cell_count(
        torch.from_numpy(rho), *tseg, p=p, n_docs=nd, block_p=bp,
        block_d=bd)) == analytic
    assert int(cnt[0].sum()) == 0          # rho = 0 runs nothing


def test_impact_scan_validation_errors():
    docs, imps = (torch.from_numpy(a) for a in _int_streams(2, 32, 40))
    with pytest.raises(ValueError, match="rho must be >= 0"):
        t_is_ops.saat_accumulate(docs, imps, n_docs=40, rho=-1)
    with pytest.raises(ValueError, match="integer dtype"):
        t_is_ops.saat_accumulate(docs, imps, n_docs=40,
                                 rho=torch.tensor([1.0, 2.0]))
    with pytest.raises(ValueError, match="shaped"):
        t_is_ops.saat_accumulate(docs, imps, n_docs=40,
                                 rho=torch.tensor([1, 2, 3],
                                                  dtype=torch.int32))
    bad = torch.zeros((2, 7), dtype=torch.int32)
    with pytest.raises(ValueError, match="segment bounds"):
        t_is_ops.saat_accumulate(docs, imps, n_docs=40,
                                 rho=torch.tensor([1, 2], dtype=torch.int32),
                                 block_p=8, seg_bounds=(bad, bad))


def test_impact_scan_rho_zero_launches_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("impact_scan ran for a static rho of 0")

    monkeypatch.setattr(t_is_kernel, "impact_scan", boom)
    monkeypatch.setattr(t_is_kernel, "n_launches", 0)
    docs, imps = (torch.from_numpy(a) for a in _int_streams(2, 32, 40))
    out = t_is_ops.saat_accumulate(docs, imps, n_docs=40, rho=0)
    assert out.shape == (2, 40) and not out.any()
    out, cnt = t_is_ops.saat_accumulate(docs, imps, n_docs=40, rho=0,
                                        with_stats=True)
    assert not out.any() and not cnt.any() and cnt.shape == (2, 1)
    assert t_is_kernel.n_launches == 0


def test_cpu_tensors_never_count_as_launches(monkeypatch):
    """The counters move only where a kernel launches: CPU tensors run
    the plain versions and leave them at 0."""
    monkeypatch.setattr(t_is_kernel, "n_launches", 0)
    monkeypatch.setattr(t_tk_kernel, "n_launches", 0)
    docs, imps = (torch.from_numpy(a) for a in _int_streams(2, 64, 50))
    t_is_ops.saat_accumulate(docs, imps, n_docs=50,
                             rho=torch.tensor([3, 64], dtype=torch.int32))
    t_tk_ops.topk_select(imps, 5, block_n=16)
    assert t_is_kernel.n_launches == 0 and t_tk_kernel.n_launches == 0


# ------------------------------------------------------------------ topk --

@pytest.mark.parametrize("q,n,kp,bn", [
    (2, 1000, 10, 256), (1, 5000, 64, 512), (3, 300, 128, 128),
    (1, 257, 7, 64), (2, 40, 5, 16), (1, 5, 3, 2),   # kp > block width
])
def test_block_topk_plain_matches_pallas(q, n, kp, bn):
    """Raw per-block outputs, -inf rounds and their block-base indices
    included, are the Pallas kernel's."""
    s = np.random.default_rng(q * n + kp).normal(size=(q, n))
    s = np.round(s * 4).astype(np.float32)      # many ties
    jv, ji = j_tk_kernel.block_topk(jnp.asarray(s), kp=kp, block_n=bn,
                                    interpret=True)
    tv, ti = t_tk_kernel.block_topk(torch.from_numpy(s), kp=kp, block_n=bn)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("q,n,k,bn", [
    (2, 1000, 10, 256), (1, 5000, 64, 512), (3, 300, 128, 128),
    (1, 257, 7, 64), (2, 3000, 200, 4096),     # k > KP_MAX: the oracle
])
def test_topk_select_matches_jax(q, n, k, bn):
    s = np.random.default_rng(n + k).normal(size=(q, n))
    s = np.round(s * 8).astype(np.float32)
    jv, ji = j_tk_ops.topk_select(jnp.asarray(s), k, block_n=bn,
                                  interpret=True)
    tv, ti = t_tk_ops.topk_select(torch.from_numpy(s), k, block_n=bn)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ov, oi = t_tk_ops.topk_select(torch.from_numpy(s), k, use_kernel=False)
    np.testing.assert_array_equal(oi.numpy(), ti.numpy())


def test_block_topk_rejects_invalid_kp():
    s = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 512)).astype(np.float32))
    for kp in (0, -3, t_tk_kernel.KP_MAX + 1, 500):
        with pytest.raises(ValueError, match=r"kp must be in \[1, 128\]"):
            t_tk_kernel.block_topk(s, kp=kp, block_n=256)


def test_topk_wide_k_routes_to_oracle(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("block_topk ran for k > KP_MAX")

    monkeypatch.setattr(t_tk_kernel, "block_topk", boom)
    s = np.random.default_rng(1).normal(size=(2, 512)).astype(np.float32)
    import jax
    vr, ir = jax.lax.top_k(jnp.asarray(s), 178)
    tv, ti = t_tk_ops.topk_select(torch.from_numpy(s), 178)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ir))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vr))


def test_topk_ties_prefer_low_index():
    s = torch.tensor([[1.0, 5.0, 5.0, 0.0, 5.0]])
    _, idx = t_tk_ops.topk_select(s, 3, block_n=2)
    assert idx[0].tolist() == [1, 2, 4]

