"""The port's distribution layer against the JAX package's on the CPU.

One subprocess runs the JAX side on a forced 4-device mesh (as
``tests/test_distributed.py`` does): the shard_map MoE (forward and
gradients) on (data=2, model=2), the int8 compressed all-reduce over
(data=4,) with a bfloat16 leaf and a second round of error feedback,
``reshard`` and ``restore_elastic`` of a checkpoint it writes onto
(2, 2) and (4,); it saves every result to one ``.npz``.  The port's
counterparts run over ``DeviceMesh``es of CPU positions: the MoE within
1e-5, everything else bit for bit.  Also: ``hints_ctx`` semantics, and
the flash wrappers on a real CPU tensor (the plain result) and on fake
CUDA and meta tensors (the kernel's shapes, no launch, no plain run).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.distrib import elastic as t_elastic  # noqa: E402
from repro_torch.distrib import hints as t_hints  # noqa: E402
from repro_torch.distrib import sharding as t_S  # noqa: E402
from repro_torch.distrib.sharding import DeviceMesh  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.optim import compression as t_comp  # noqa: E402

_JAX = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import sys; sys.path.insert(0, "src")
    import dataclasses, jax, jax.numpy as jnp, numpy as np
    from repro.models import moe as M
    from repro.distrib import hints as H, elastic, sharding as S
    from repro.distrib.sharding import make_compat_mesh
    from repro.optim import compression
    from repro.ckpt import checkpoint as ckpt
    out_path, ck_dir = sys.argv[1], sys.argv[2]
    out = {}
    mesh = make_compat_mesh((2, 2), ("data", "model"))
    cfg = M.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                      capacity_factor=8.0, dispatch="shard_map")
    rng = np.random.default_rng(0)
    d = 12
    params = {k: jnp.asarray(rng.normal(0, 0.2, s).astype(np.float32))
              for k, s in [("router", (d, 8)), ("w_gate", (8, d, 16)),
                           ("w_up", (8, d, 16)), ("w_down", (8, 16, d))]}
    x = jnp.asarray(rng.normal(size=(32, d)).astype(np.float32))
    with H.hints_ctx({"mesh": mesh}):
        y, _ = jax.jit(lambda p, x: M.moe_ffn(p, x, cfg))(params, x)
        gp, gx = jax.jit(jax.grad(lambda p, x: M.moe_ffn(p, x, cfg)[0].sum(),
                                  argnums=(0, 1)))(params, x)
    out["moe/y"] = np.asarray(y); out["moe/gx"] = np.asarray(gx)
    for k, v in gp.items():
        out["moe/g/" + k] = np.asarray(v)

    mesh1 = make_compat_mesh((4,), ("data",))
    r2 = np.random.default_rng(2)
    g4 = {"w": jnp.asarray(r2.normal(size=(4, 128)).astype(np.float32)),
          "b": jnp.asarray(r2.normal(size=(4, 3, 40)).astype(np.float32))
          .astype(jnp.bfloat16)}
    e4 = jax.tree.map(jnp.zeros_like, g4)
    for rnd in range(2):
        mean, e4 = compression.compressed_allreduce(mesh1, g4, e4, "data")
        for k in g4:
            out[f"comp/{rnd}/mean/{k}"] = np.asarray(
                mean[k].astype(jnp.float32))
            out[f"comp/{rnd}/err/{k}"] = np.asarray(e4[k].astype(jnp.float32))

    tree = {"table": r2.normal(size=(64, 32)).astype(np.float32),
            "mlp": [{"w": r2.normal(size=(256, 256)).astype(np.float32),
                     "b": r2.normal(size=(8,)).astype(np.float32)}],
            "items": r2.normal(size=(12, 6)).astype(np.float32)}
    ckpt.save(ck_dir, tree, step=3)
    P = jax.sharding.PartitionSpec

    def data_specs(t, m):
        return {"table": P("data", None), "items": P(None, None),
                "mlp": [{"w": P(None, "data"), "b": P(None)}]}

    for name, m, fn in (("2x2", mesh, S.recsys_param_specs),
                        ("4", make_compat_mesh((4,), ("data",)), data_specs)):
        for how in ("reshard", "restore"):
            if how == "reshard":
                placed = elastic.reshard(tree, m, fn)
            else:
                placed, _ = elastic.restore_elastic(ck_dir, tree, m, fn)
            flat = jax.tree_util.tree_flatten_with_path(placed)[0]
            for path, arr in flat:
                key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                               for p in path)
                by_dev = {s.device.id: np.asarray(s.data)
                          for s in arr.addressable_shards}
                for i, dv in enumerate(m.devices.flat):
                    out[f"{how}/{name}/{key}/{i}"] = by_dev[dv.id]
    np.savez(out_path, **out)
    print("JAX_OK")
""")


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("distrib")
    path, ck = d / "jax.npz", d / "ck"
    r = subprocess.run([sys.executable, "-c", _JAX, str(path), str(ck)],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert "JAX_OK" in r.stdout, r.stdout + r.stderr[-3000:]
    return dict(np.load(path)), str(ck)


def _mesh(shape, names):
    return DeviceMesh(["cpu"] * int(np.prod(shape)), shape, names)


def test_moe_shard_map_matches_jax(jax_out):
    want, _ = jax_out
    cfg = t_moe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                          capacity_factor=8.0, dispatch="shard_map")
    rng = np.random.default_rng(0)
    d = 12
    params = {k: torch.tensor(rng.normal(0, 0.2, s).astype(np.float32),
                              requires_grad=True)
              for k, s in [("router", (d, 8)), ("w_gate", (8, d, 16)),
                           ("w_up", (8, d, 16)), ("w_down", (8, 16, d))]}
    x = torch.tensor(rng.normal(size=(32, d)).astype(np.float32),
                     requires_grad=True)
    with t_hints.hints_ctx({"mesh": _mesh((2, 2), ("data", "model"))}):
        y, _ = t_moe.moe_ffn(params, x, cfg)
    grads = torch.autograd.grad(y.sum(), [*params.values(), x])
    np.testing.assert_allclose(y.detach().numpy(), want["moe/y"], rtol=0,
                               atol=1e-5)
    for k, g in zip([*params, "x"], grads):
        ref = want["moe/gx"] if k == "x" else want["moe/g/" + k]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-5,
                                   err_msg=k)


def test_moe_shard_map_equals_local_path():
    """With a mesh whose token count does not divide (decode), or none,
    the local path runs whatever ``dispatch`` says."""
    cfg = t_moe.MoEConfig(n_experts=4, top_k=2, d_ff_expert=8,
                          dispatch="shard_map")
    g = torch.Generator().manual_seed(1)
    params = {"router": torch.randn(6, 4, generator=g),
              "w_gate": torch.randn(4, 6, 8, generator=g),
              "w_up": torch.randn(4, 6, 8, generator=g),
              "w_down": torch.randn(4, 8, 6, generator=g)}
    x = torch.randn(6, 6, generator=g)
    local = t_moe.moe_ffn(params, x, dataclasses.replace(cfg,
                                                         dispatch="gspmd"))
    with t_hints.hints_ctx({"mesh": _mesh((2, 2), ("data", "model"))}):
        y, aux = t_moe.moe_ffn(params, x, cfg)        # 6 % 4 != 0
    assert torch.equal(y, local[0]) and torch.equal(aux, local[1])


def test_compressed_allreduce_bit_equal_to_jax(jax_out):
    want, _ = jax_out
    r2 = np.random.default_rng(2)
    g4 = {"w": torch.tensor(r2.normal(size=(4, 128)).astype(np.float32)),
          "b": torch.tensor(r2.normal(size=(4, 3, 40)).astype(np.float32))
          .to(torch.bfloat16)}
    e4 = {k: torch.zeros_like(v) for k, v in g4.items()}
    mesh = _mesh((4,), ("data",))
    for rnd in range(2):
        mean, e4 = t_comp.compressed_allreduce(mesh, g4, e4, "data")
        for k in g4:
            assert mean[k].dtype == g4[k].dtype
            assert np.array_equal(mean[k].float().numpy(),
                                  want[f"comp/{rnd}/mean/{k}"]), (rnd, k)
            assert np.array_equal(e4[k].float().numpy(),
                                  want[f"comp/{rnd}/err/{k}"]), (rnd, k)


def test_quantize_rounds_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0])
    q = t_comp.quantize(x, torch.tensor(1.0))
    assert q.tolist() == [0, 2, 2, 0, -2, 127]
    assert q.dtype == torch.int8


def _tree():
    r2 = np.random.default_rng(2)
    r2.normal(size=(4, 128)), r2.normal(size=(4, 3, 40))   # the JAX draws
    return {"table": torch.tensor(r2.normal(size=(64, 32)).astype(np.float32)),
            "mlp": [{"w": torch.tensor(r2.normal(size=(256, 256))
                                       .astype(np.float32)),
                     "b": torch.tensor(r2.normal(size=(8,))
                                       .astype(np.float32))}],
            "items": torch.tensor(r2.normal(size=(12, 6)).astype(np.float32))}


@pytest.mark.parametrize("name,shape,names", [
    ("2x2", (2, 2), ("data", "model")), ("4", (4,), ("data",))])
@pytest.mark.parametrize("how", ["reshard", "restore"])
def test_elastic_shards_bit_equal_to_jax(jax_out, name, shape, names, how):
    want, ck = jax_out
    tree = _tree()
    mesh = _mesh(shape, names)
    fn = t_S.recsys_param_specs if name == "2x2" else _data_specs
    if how == "reshard":
        placed = t_elastic.reshard(tree, mesh, fn)
    else:
        placed, _ = t_elastic.restore_elastic(ck, tree, mesh, fn)
    n = 0
    for path, shards in _shard_lists(placed):
        assert len(shards) == mesh.devices.size
        for i, s in enumerate(shards):
            assert s.device == mesh.devices.flat[i]
            assert np.array_equal(s.numpy(), want[f"{how}/{name}/{path}/{i}"]), \
                (path, i)
            n += 1
    assert n == 4 * mesh.devices.size


def _data_specs(tree, mesh):
    """Specs over a data-only mesh (``recsys_param_specs`` names
    'model')."""
    P = t_S.P
    return {"table": P("data", None), "items": P(None, None),
            "mlp": [{"w": P(None, "data"), "b": P(None)}]}


def _shard_lists(tree, prefix=()):
    """(path, per-position shards) of a placed tree: a leaf is a list of
    tensors."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _shard_lists(tree[k], prefix + (k,))
    elif isinstance(tree, list) and tree and isinstance(tree[0],
                                                        torch.Tensor):
        yield "/".join(str(p) for p in prefix), tree
    else:
        for i, v in enumerate(tree):
            yield from _shard_lists(v, prefix + (i,))


def test_shards_concatenate_to_the_leaf():
    mesh = _mesh((2, 2), ("data", "model"))
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    shards = t_S.NamedSharding(mesh, t_S.P("data", "model")).shard(t)
    rows = [torch.cat(shards[2 * r:2 * r + 2], dim=1) for r in range(2)]
    assert torch.equal(torch.cat(rows, dim=0), t)
    both = t_S.NamedSharding(mesh, t_S.P(("model", "data"))).shard(t)
    # model major: position (data=0, model=1) holds block 2
    assert torch.equal(both[1], t[4:6])


def test_hints_ctx_semantics():
    t_hints.set_hints({})
    assert t_hints.get("mesh") is None and t_hints.get("x", 3) == 3
    x = torch.ones(2)
    with t_hints.hints_ctx({"mesh": "m", "lm_activations": object()}):
        assert t_hints.get("mesh") == "m"
        assert t_hints.hint(x, "lm_activations") is x       # plain tensor
        assert t_hints.hint(x, "absent") is x
        with t_hints.hints_ctx({"mesh": "inner"}):
            assert t_hints.get("mesh") == "inner"
            assert t_hints.get("lm_activations") is None
        assert t_hints.get("mesh") == "m"
    assert t_hints.get("mesh") is None
    with pytest.raises(KeyError):
        with t_hints.hints_ctx({"mesh": "m"}):
            raise KeyError("inside")
    assert t_hints.get("mesh") is None


def _counters():
    return (fa_kernel.n_launches, fa_kernel.last_route,
            dict(fa_kernel.route_launches))


def test_flash_wrappers_real_cpu_runs_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 4, 8, generator=g)
    k = torch.randn(2, 16, 2, 8, generator=g)
    v = torch.randn(2, 16, 2, 8, generator=g)
    before = _counters()
    out = fa_kernel.flash_attention_bshd(q, k, v, causal=True)
    assert torch.equal(out, fa_ref.attention_ref_bshd(q, k, v, causal=True))
    assert _counters() == before


@pytest.mark.parametrize("where", ["fake_cuda", "meta"])
def test_flash_wrappers_on_fake_tensors_launch_nothing(where, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a fake tensor")
    monkeypatch.setattr(fa_kernel, "attention_ref_bshd", refuse)
    monkeypatch.setattr(fa_kernel, "attention_ref", refuse)
    before = _counters()
    import contextlib
    ctx = FakeTensorMode() if where == "fake_cuda" else contextlib.nullcontext()
    dev = "cuda" if where == "fake_cuda" else "meta"
    with ctx:
        q = torch.empty(2, 64, 8, 16, dtype=torch.bfloat16, device=dev)
        kv = torch.empty(2, 64, 2, 16, dtype=torch.bfloat16, device=dev)
        o = fa_kernel.flash_attention_bshd(q, kv, kv, causal=True)
        q3 = torch.empty(2, 64, 16, dtype=torch.bfloat16, device=dev)
        o3 = fa_kernel.flash_attention_fwd(q3, q3, q3)
    assert o.shape == q.shape and o.dtype == q.dtype
    assert o3.shape == (2, 64, 16)
    assert str(o.device).startswith(dev)
    assert _counters() == before


def test_flash_training_route_on_meta_tensors():
    """``ops.FlashAttention`` forward (the fake branch) and its blocked
    backward run on meta tensors: the gradients' shapes, no launch."""
    before = _counters()
    q = torch.empty(2, 64, 8, 16, device="meta", requires_grad=True)
    kv = torch.empty(2, 64, 2, 16, device="meta", requires_grad=True)
    o = fa_ops.flash_attention(q, kv, kv, causal=True, block_q=16)
    dq, dk = torch.autograd.grad(o.sum(), [q, kv])
    assert dq.shape == q.shape and dk.shape == kv.shape
    assert _counters() == before


def test_flash_flop_formula():
    from torch.utils.flop_counter import FlopCounterMode
    q = torch.empty(2, 64, 8, 16, device="meta")
    kv = torch.empty(2, 64, 2, 16, device="meta")
    with FlopCounterMode(display=False) as fc:
        fa_kernel.flash_attention_bshd(q, kv, kv)
    assert fc.get_total_flops() == 4 * 2 * 8 * 64 * 64 * 16
    with FlopCounterMode(display=False) as fc:
        fa_ref.attention_ref_bshd(torch.zeros(2, 64, 8, 16),
                                  torch.zeros(2, 64, 2, 16),
                                  torch.zeros(2, 64, 2, 16))
    assert fc.get_total_flops() == 4 * 2 * 8 * 64 * 64 * 16


def test_blocked_backward_with_offset_equals_its_rows():
    """The dry run's sequence-parallel backward: q rows [16, 32) against
    all 32 keys give the whole backward's dq rows there, and the dk, dv
    parts of those rows."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, 32, 4, 8, generator=g, dtype=torch.float64)
    k = torch.randn(1, 32, 2, 8, generator=g, dtype=torch.float64)
    v = torch.randn(1, 32, 2, 8, generator=g, dtype=torch.float64)
    o = fa_ref.attention_ref_bshd(q, k, v, causal=True)
    do = torch.randn(1, 32, 4, 8, generator=g, dtype=torch.float64)
    dq, dk, dv = fa_ops.flash_attention_bwd_blocked(q, k, v, o, do,
                                                    causal=True, block_q=8)
    a = fa_ops.flash_attention_bwd_blocked(q[:, :16], k, v, o[:, :16],
                                           do[:, :16], causal=True, block_q=8)
    b = fa_ops.flash_attention_bwd_blocked(q[:, 16:], k, v, o[:, 16:],
                                           do[:, 16:], causal=True, block_q=8,
                                           q_offset=16)
    torch.testing.assert_close(torch.cat([a[0], b[0]], dim=1), dq)
    torch.testing.assert_close(a[1] + b[1], dk)
    torch.testing.assert_close(a[2] + b[2], dv)
