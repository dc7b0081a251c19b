"""The port's kernel modules against the JAX package's kernels.

On the CPU the port's kernel wrappers run their plain torch versions;
they are held here against the Pallas kernels in interpret mode and
against the jnp oracles.  Tolerances, with their reasons:
  * impact_scan and topk: exact.  Impacts are integer-valued float32
    (partial sums below 2^24), and top-k is a selection, so every output
    must be bit-identical.
  * flash_attention: 2e-5 in float32 and 2e-2 in bfloat16, the
    tolerances of the JAX package's own kernel tests (exp and the order
    of sums differ between online and plain softmax).
  * embedding_bag: bit-equal to the Pallas kernel (both add the slots
    left to right); rtol 1e-5 / atol 1e-6 against the jnp oracle, which
    sums the slot axis in its own order.  In bfloat16 the Pallas kernel
    and the port round the sum after every slot, and the jnp oracle
    (``bag_fixed``) sums in float32 and rounds once: against it the
    error is held to the bound of L rounded adds, L * 2^-8 * sum |row|.
The CUDA kernels themselves are compared with the plain versions on the
card (tests/test_torch_gpu.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import kernel as j_eb_kernel
from repro.kernels.embedding_bag import ops as j_eb_ops
from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.kernels.impact_scan import kernel as j_is_kernel
from repro.kernels.impact_scan import ops as j_is_ops
from repro.kernels.topk import kernel as j_tk_kernel
from repro.kernels.topk import ops as j_tk_ops
from repro.models.recsys import embedding as j_embedding
from repro.retrieval import index as j_index
from repro_torch.kernels.embedding_bag import kernel as t_eb_kernel
from repro_torch.kernels.embedding_bag import ops as t_eb_ops
from repro_torch.kernels.embedding_bag import ref as t_eb_ref
from repro_torch.kernels.flash_attention import kernel as t_fa_kernel
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.impact_scan import kernel as t_is_kernel
from repro_torch.kernels.impact_scan import ops as t_is_ops
from repro_torch.kernels.impact_scan.ref import impact_scan_ref
from repro_torch.kernels.topk import kernel as t_tk_kernel
from repro_torch.kernels.topk import ops as t_tk_ops
from repro_torch.kernels.topk.edge_scores import KINDS, edge_scores
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
    (3, 500, 3001, 128, 777, True),   # block_d divides neither n_docs
    #                                   nor the CUDA tile (57 344 docs)
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
    monkeypatch.setattr(t_fa_kernel, "n_launches", 0)
    monkeypatch.setattr(t_eb_kernel, "n_launches", 0)
    x = torch.zeros((1, 8, 2, 4))
    t_fa_ops.flash_attention(x, x, x)
    t_eb_ops.embedding_bag(torch.zeros((5, 4)),
                           torch.tensor([[0, -1]], dtype=torch.int32))
    assert t_is_kernel.n_launches == 0 and t_tk_kernel.n_launches == 0
    assert t_fa_kernel.n_launches == 0 and t_eb_kernel.n_launches == 0


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


@pytest.mark.parametrize("kind", KINDS)
def test_block_topk_edge_inputs_match_pallas(kind):
    """Tie-heavy stage-1 rows, signed zeros and -inf scores: the raw
    per-block pairs and the merged top-k are the JAX package's."""
    s = edge_scores(kind, 2, 10_000, seed=5)    # ragged last block
    jv, ji = j_tk_kernel.block_topk(jnp.asarray(s), kp=100, block_n=4096,
                                    interpret=True)
    tv, ti = t_tk_kernel.block_topk(torch.from_numpy(s), kp=100,
                                    block_n=4096)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jv, ji = j_tk_ops.topk_select(jnp.asarray(s), 100, interpret=True)
    tv, ti = t_tk_ops.topk_select(torch.from_numpy(s), 100)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


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



# ------------------------------------------------------- flash attention --

def _qkv(b, s, hq, hkv, hd, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, s, hq, hd)).astype(dtype),
            r.normal(size=(b, s, hkv, hd)).astype(dtype),
            r.normal(size=(b, s, hkv, hd)).astype(dtype))


@pytest.mark.parametrize("b,s,hq,hkv,hd", [
    (2, 64, 4, 2, 32), (1, 128, 2, 2, 16),
    (4, 7, 2, 2, 4),               # BST-like: S = seq_len + 1, hd 4
])
@pytest.mark.parametrize("causal,window", [
    (True, None), (False, None), (True, 16),
])
def test_flash_attention_matches_pallas_and_ref(b, s, hq, hkv, hd, causal,
                                                window):
    q, k, v = _qkv(b, s, hq, hkv, hd, seed=s * hq + hd)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(j_fa_ops.flash_attention(
        jq, jk, jv, causal=causal, window=window, block_q=32, block_kv=32))
    ref = np.asarray(j_fa_ops.flash_attention(
        jq, jk, jv, causal=causal, window=window, use_kernel=False))
    out = t_fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   window=window)
    assert out.shape == (b, s, hq, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [None, 3])
def test_attention_ref_matches_jax_ref(window):
    r = np.random.default_rng(11)
    q, k, v = (r.normal(size=(6, 21, 4)).astype(np.float32)
               for _ in range(3))
    for causal in (True, False):
        j = np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       window=window))
        t = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
        np.testing.assert_allclose(t.numpy(), j, rtol=2e-5, atol=2e-5)


def test_flash_attention_bfloat16_matches_pallas():
    q, k, v = _qkv(1, 64, 4, 2, 32, seed=3)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    pallas = np.asarray(j_fa_ops.flash_attention(jq, jk, jv, block_q=32,
                                                 block_kv=32), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = t_fa_ops.flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), pallas, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (False, 16)])
def test_flash_attention_tensor_core_shapes_match_pallas(hd, causal, window):
    # bf16 at the shapes the card's tensor-core route takes (hd 64 and
    # 128, qwen2-0.5b's 14 / 2 heads, S past one 64-row warpgroup; the
    # Pallas kernel takes S in whole blocks): the plain version the card
    # holds that route against, here against the Pallas kernel in
    # interpret mode
    q, k, v = _qkv(1, 96, 14, 2, hd, seed=hd + (window or 0))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    pallas = np.asarray(j_fa_ops.flash_attention(
        jq, jk, jv, causal=causal, window=window, block_q=32, block_kv=32),
        np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = t_fa_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 96, 14, hd)
    np.testing.assert_allclose(out.float().numpy(), pallas, rtol=2e-2,
                               atol=2e-2)


def test_build_digest_covers_included_headers_and_flags(tmp_path,
                                                        monkeypatch):
    """A kernel library's name hashes the nvcc flags, its source and the
    csrc headers it includes, transitively: editing any of them builds a
    new library instead of loading a stale one."""
    from repro_torch.kernels import _build
    assert _build._sources("flash_attention")[1].name == "sm90.cuh"
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._sources("k")] == ["k.cu", "a.cuh",
                                                      "b.cuh"]
    first = _build._lib_path("k")
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build._lib_path("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    third = _build._lib_path("k")
    assert len({first, second, third}) == 3


def test_flash_attention_cutouts_apply_to_the_source():
    """Each cut of ``cutouts.py`` (a timing tool for the tensor-core
    route) matches flash_attention.cu exactly once, so it still cuts what
    it names."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import cutouts
    text = (_build.CSRC / "flash_attention.cu").read_text()
    for name, edits in cutouts.CUTS.items():
        for old, _ in edits:
            assert text.count(old) == 1, name


def test_cpu_tensors_leave_the_route_counts_alone(monkeypatch):
    monkeypatch.setattr(t_fa_kernel, "route_launches", {})
    x = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    t_fa_ops.flash_attention(x, x, x)
    assert t_fa_kernel.route_launches == {}
    assert t_fa_kernel.ROUTES[3] == "general_tc"


def test_flash_attention_validation():
    x = torch.zeros((2, 8, 4))
    with pytest.raises(ValueError, match="window must be >= 1"):
        t_fa_kernel.flash_attention_fwd(x, x, x, window=0)
    with pytest.raises(ValueError, match="one \\(BH, S, hd\\) shape"):
        t_fa_kernel.flash_attention_fwd(x, x, torch.zeros((2, 8, 8)))
    with pytest.raises(ValueError, match="multiple of the key/value heads"):
        t_fa_ops.flash_attention(torch.zeros((1, 8, 3, 4)),
                                 torch.zeros((1, 8, 2, 4)),
                                 torch.zeros((1, 8, 2, 4)))


def _strided_qkv(kind, b, s, hq, hkv, hd, seed):
    """Seeded q (B, S, Hq, hd) and k, v (B, S, Hkv, hd) as views that are
    not contiguous: ``transposed`` reads (B, H, S, hd) storage through a
    transpose; ``sliced`` takes every other batch row of a wider tensor
    after the first (batch stride 2 S H hd); ``head_slice`` takes the
    last hd of a last axis twice as wide; ``broadcast`` is ``sliced`` with
    k and v one head expanded over Hkv (head stride 0)."""
    r = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(r.normal(size=shape).astype(np.float32))

    def make(h):
        if kind == "transposed":
            return normal(b, h, s, hd).transpose(1, 2)
        if kind == "head_slice":
            return normal(b, s, h, 2 * hd)[..., hd:]
        return normal(2 * b + 1, s, h, hd)[1::2]

    if kind == "broadcast":
        q = make(hq)
        k, v = (normal(b, s, 1, hd).expand(b, s, hkv, hd) for _ in range(2))
        return q, k, v
    return make(hq), make(hkv), make(hkv)


@pytest.mark.parametrize("kind", ["transposed", "sliced", "head_slice",
                                  "broadcast"])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("causal,window", [(False, None), (True, 5)])
def test_flash_attention_strided_views_match_pallas_and_ref(kind, g, causal,
                                                            window):
    """BST's shape (S = 21, 8 query heads of 4) through views that are not
    contiguous, with GQA groups of g: the port reads them as they are and
    returns a contiguous (B, S, Hq, hd)."""
    q, k, v = _strided_qkv(kind, 3, 21, 8, 8 // g, 4, seed=10 * g + causal)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    pallas = np.asarray(j_fa_ops.flash_attention(
        jq, jk, jv, causal=causal, window=window, block_q=32, block_kv=32))
    ref = np.asarray(j_fa_ops.flash_attention(
        jq, jk, jv, causal=causal, window=window, use_kernel=False))
    for use_kernel in (True, False):
        out = t_fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                       use_kernel=use_kernel)
        assert out.shape == (3, 21, 8, 4) and out.is_contiguous()
        np.testing.assert_allclose(out.numpy(), pallas, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


# --------------------------------------------------------- embedding bag --

@pytest.mark.parametrize("v,d,b,l,comb", [
    (100, 16, 8, 5, "sum"), (50, 8, 4, 3, "mean"), (30, 32, 16, 1, "sum"),
    (200, 64, 2, 7, "mean"), (40, 5, 6, 4, "sum"),   # D not a multiple of 4
])
def test_embedding_bag_matches_pallas_and_oracle(v, d, b, l, comb):
    r = np.random.default_rng(v * d + l)
    table = r.normal(size=(v, d)).astype(np.float32)
    ids = r.integers(-1, v, (b, l)).astype(np.int32)
    ids[0] = -1                                    # a bag of padding only
    jt, ji = jnp.asarray(table), jnp.asarray(ids)
    pallas = np.asarray(j_eb_kernel.embedding_bag_kernel(
        jt, ji, mean=comb == "mean", interpret=True))
    oracle = np.asarray(j_embedding.bag_fixed(jt, ji, comb))
    out = t_eb_ops.embedding_bag(torch.from_numpy(table),
                                 torch.from_numpy(ids), combiner=comb)
    np.testing.assert_array_equal(out.numpy(), pallas)
    np.testing.assert_allclose(out.numpy(), oracle, rtol=1e-5, atol=1e-6)
    assert not out[0].any()
    ref = t_eb_ref.embedding_bag_ref(torch.from_numpy(table),
                                     torch.from_numpy(ids),
                                     mean=comb == "mean")
    np.testing.assert_allclose(ref.numpy(), np.asarray(
        j_eb_ops.embedding_bag(jt, ji, combiner=comb, use_kernel=False)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("v,d,b,l,comb", [
    (50, 8, 6, 5, "sum"), (1000, 32, 300, 8, "mean"), (500, 16, 200, 20,
                                                       "sum"),
    (40, 5, 9, 4, "mean"),
])
def test_embedding_bag_bfloat16_matches_pallas_and_bag_fixed(v, d, b, l,
                                                             comb):
    """A bfloat16 table: the output stays bfloat16, bit-equal to the
    Pallas kernel, which accumulates in the table's dtype."""
    r = np.random.default_rng(v + d + l)
    table = r.normal(0, d ** -0.5, (v, d)).astype(np.float32)
    ids = r.integers(0, v, (b, l)).astype(np.int32)
    ids[r.random((b, l)) < 0.3] = -1
    ids[1] = -1                                    # a bag of padding only
    jt, ji = jnp.asarray(table, jnp.bfloat16), jnp.asarray(ids)
    pallas = j_eb_kernel.embedding_bag_kernel(jt, ji, mean=comb == "mean",
                                              interpret=True)
    tt = torch.from_numpy(table).to(torch.bfloat16)
    out = t_eb_ops.embedding_bag(
        tt, torch.from_numpy(ids), combiner=comb)
    assert out.dtype == torch.bfloat16 and not out[1].any()
    np.testing.assert_array_equal(
        out.view(torch.int16).numpy(),
        np.asarray(pallas).view(np.int16))
    oracle = np.asarray(j_embedding.bag_fixed(jt, ji, comb), np.float32)
    rows = np.abs(tt.float().numpy()[np.maximum(ids, 0)])
    bound = l * 2.0 ** -8 * (rows * (ids >= 0)[..., None]).sum(1)
    assert (np.abs(out.float().numpy() - oracle)
            <= bound).all()


def test_embedding_bag_all_padding_and_validation():
    table = torch.from_numpy(np.random.default_rng(0).normal(
        size=(10, 4)).astype(np.float32))
    ids = torch.full((2, 3), -1, dtype=torch.int32)
    for comb in ("sum", "mean"):
        assert not t_eb_ops.embedding_bag(table, ids, combiner=comb).any()
    with pytest.raises(ValueError, match="combiner"):
        t_eb_ops.embedding_bag(table, ids, combiner="max")
    with pytest.raises(ValueError, match="integer tensor"):
        t_eb_kernel.embedding_bag_kernel(table, ids.float())
