"""The reference's sharding hints under DTensor (ROADMAP items 8h, 8f).

The small cells: tinyllama-1.1b's and deepseek-v3-671b's smoke configs,
a training step of batch 8 x seq 256, on a (2, 4) data x model mesh,
the reference compiled by XLA over 8 forced host devices (one
subprocess), the port traced by ``launch.dryrun.trace_bundle`` on 8
fake positions (one subprocess a cell: the fake process group is global
to its process), all started together.  deepseek's smoke config has 8
experts, which divide over the 8 positions, so ``REPRO_MOE_SHARDMAP=1``
takes the shard_map dispatch in both packages.

In the port's trace every ``hints.hint`` call is recorded (name, caller,
forward or backward, placements in and out) by a stand-in that calls
the real one.  The tests hold:

* the residual stream in ``lm_activations``' layout, ``(Shard(0),
  Shard(1))`` over ``(data, model)``, at every hint, in forward and in
  the checkpointed layers' recompute, and already there at every layer
  boundary (nothing between two hints moved it);
* the port's bytes of each collective kind, equal to the count worked
  out from the shapes and the layer's redistributions;
* the two MoE dispatches as two programs, shard_map's all-to-all bytes
  above gspmd's in both packages, the gspmd buffer in ``moe_buffer``'s
  layout;
* on LocalTensor ranks (``torch.distributed._local_tensor``: eight
  ranks' values in one process), the gspmd body's values and gradients
  equal ``moe_ffn``'s on one device, and ``layers.linear``'s equal
  ``x @ w``, for each layout the dry run gives them;
* on plain tensors the installed hints change no bit of a training
  loss.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)

from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import lm_common as t_lm  # noqa: E402
from repro_torch.distrib import hints as t_hints  # noqa: E402
from repro_torch.distrib import sharding as t_sh  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

#: the small cells' step and mesh
SHAPE = dict(kind="train", seq_len=256, batch=8)
MESH = (2, 4)
#: (arch, REPRO_MOE_SHARDMAP)
CELLS = [("tinyllama-1.1b", "0"), ("deepseek-v3-671b", "0"),
         ("deepseek-v3-671b", "1")]

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, "src")
    import jax
    from repro.configs import base, lm_common
    from repro.distrib import hints as H
    from repro.distrib.sharding import make_compat_mesh
    from repro.launch.dryrun import collective_bytes
    lm_common.LM_SHAPES["small"] = json.loads(sys.argv[1])
    mesh = make_compat_mesh(tuple(json.loads(sys.argv[2])),
                            ("data", "model"))
    out = {}
    for arch, sm in json.loads(sys.argv[3]):
        os.environ["REPRO_MOE_SHARDMAP"] = sm
        b = lm_common.bundle(base.get(arch).smoke_config(), "small", mesh,
                             mode="mem")
        with H.hints_ctx(b.hints):
            c = jax.jit(b.fn, in_shardings=b.in_shardings,
                        out_shardings=b.out_shardings,
                        donate_argnums=b.donate_argnums).lower(
                *b.args).compile()
        out[arch + "/" + sm] = {
            "collectives": collective_bytes(c.as_text()),
            "temp_bytes": c.memory_analysis().temp_size_in_bytes}
    print(json.dumps(out))
""")

_PORT = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs import base, lm_common
    from repro_torch.distrib import hints as H
    from repro_torch.distrib.sharding import DeviceMesh
    from repro_torch.launch import dryrun
    shape, mesh_shape, arch = json.loads(sys.argv[1]), json.loads(
        sys.argv[2]), sys.argv[3]
    lm_common.LM_SHAPES["small"] = shape
    mesh = DeviceMesh(["meta"] * (mesh_shape[0] * mesh_shape[1]),
                      mesh_shape, ("data", "model"))
    log, real = [], H.hint

    def pl(x):
        # one spelling whatever the torch version prints
        if not hasattr(x, "placements"):
            return None
        return [f"{type(p).__name__.lstrip('_')}({getattr(p, 'dim', '')})"
                for p in x.placements]

    def hint(x, name):
        out = real(x, name)
        log.append({"name": name, "caller": sys._getframe(1).f_code.co_name,
                    "phase": ("backward"
                              if torch._C._current_graph_task_id() >= 0
                              else "forward"),
                    "in": pl(x), "out": pl(out)})
        return out

    H.hint = hint
    b = lm_common.bundle(base.get(arch).smoke_config(), "small", mesh,
                         mode="mem")
    rec = dryrun.trace_bundle(b, mesh)
    print(json.dumps({"collectives": rec["collectives"],
                      "temp_bytes": rec["memory"]["temp_bytes"],
                      "replicated_ops": rec["replicated_ops"],
                      "hints": log}))
""")


@pytest.fixture(scope="module")
def records():
    """{"reference" | "port": {"<arch>/<switch>": record}}: the
    reference's compiles in one subprocess and the port's traces in one
    each, all started together."""
    args = [json.dumps(SHAPE), json.dumps(list(MESH))]
    procs = {"reference": subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, *args, json.dumps(CELLS)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=SRC))}
    for arch, sm in CELLS:
        procs[arch + "/" + sm] = subprocess.Popen(
            [sys.executable, "-c", _PORT, *args, arch], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=SRC, REPRO_MOE_SHARDMAP=sm))
    out = {"reference": None, "port": {}}
    for key, p in procs.items():
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, (key, se[-3000:])
        got = json.loads(so.splitlines()[-1])
        if key == "reference":
            out["reference"] = got
        else:
            out["port"][key] = got
    return out


def _tuple(placements):
    return tuple(placements)


SEQ_SHARDED = ("Shard(0)", "Shard(1)")


def test_the_residual_stream_stays_sequence_sharded(records):
    """tinyllama: every ``lm_activations`` hint leaves the (B, S, D)
    stream batch-split over ``data`` and sequence-split over ``model``.
    Forward: the embedding, each layer's boundary, its attention's exit
    and its FFN's exit.  The checkpointed recompute in backward pins
    each layer's attention exit again (it stops before the FFN's exit,
    whose output backward does not read).  At every boundary the stream
    arrives already in that layout: nothing between two hints moved
    it."""
    n_layers = t_base.get("tinyllama-1.1b").smoke_config().n_layers
    log = [h for h in records["port"]["tinyllama-1.1b/0"]["hints"]
           if h["name"] == "lm_activations"]
    assert log and all(_tuple(h["out"]) == SEQ_SHARDED for h in log)
    fwd = [h["caller"] for h in log if h["phase"] == "forward"]
    bwd = [h["caller"] for h in log if h["phase"] == "backward"]
    assert fwd == ["backbone"] + ["_run_layers", "_layer_body",
                                  "_layer_body"] * n_layers
    assert bwd == ["_layer_body"] * n_layers
    assert all(_tuple(h["in"]) == SEQ_SHARDED for h in log
               if h["caller"] == "_run_layers")


def test_port_bytes_follow_from_the_shapes_and_redistributions(records):
    """tinyllama's per-kind bytes a device (result bytes, float32
    smoke weights and activations, int64 ids), worked out collective by
    collective.  b = B/dp rows of the batch, s = S/tp of the sequence,
    tp = 4 over ``model``, dp = 2 over ``data``; every weight of the
    smoke config is below FSDP's 2**16 elements, so only the vocabulary
    (``embed``, ``lm_head``) and the FFN's width (``w_gate``, ``w_up``,
    ``w_down``) are split, over ``model``."""
    cfg = t_base.get("tinyllama-1.1b").smoke_config()
    B, S = SHAPE["batch"], SHAPE["seq_len"]
    dp, tp = MESH
    b, s, f4, i8 = B // dp, S // tp, 4, 8
    D, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    kv = cfg.n_kv_heads * cfg.head_dim           # one token's k (or v)
    hq = cfg.n_heads * cfg.head_dim              # one token's q
    F = cfg.d_ff // tp                            # a device's FFN width
    stream = b * S * D * f4                       # a gathered (b, S, D)
    shard = b * s * D * f4                        # a (b, s, D) shard
    all_gather = (
        # the embedding (D split with the vocabulary-parallel table)
        # into the hint, Shard(2) -> Shard(1), and its backward
        2 * stream
        # a layer, forward and recompute: k and v gathered over model
        # for the sequence-parallel attention, and the FFN's input
        + L * 2 * (2 * b * S * kv * f4 + stream)
        # a layer's backward: the FFN's exit reduce-scatter's gradient
        + L * stream
        # the embedding's backward: ids and D-split rows over data
        + B * S * i8 + B * S * (D // tp) * f4)
    reduce_scatter = L * (
        shard                                     # the FFN's exit
        + shard                                   # its input's gradient
        + 2 * b * s * kv * f4)                    # dk, dv to their shards
    rows = b * s                                  # the loss's rows
    all_reduce = (
        # the vocabulary-parallel loss: max, sum of exp and the target's
        # logit a row, forward and its recompute, and the mean
        2 * 3 * rows * f4 + f4
        # lm_head's gradient (D, V/tp) summed over data
        + D * (V // tp) * f4
        # a layer's weight gradients, summed over each mesh dim that
        # split the rows they multiplied: wq and wo over data and model,
        # wk and wv too, w_gate, w_up and w_down over data
        + L * (2 * 2 * D * hq * f4 + 2 * 2 * D * kv * f4 + 3 * D * F * f4)
        # ln1 and ln2 (L, D) and final_norm (D,) over data and model, in
        # the optimizer, and the gradient's global norm
        + 2 * 2 * L * D * f4 + 2 * D * f4 + f4)
    assert records["port"]["tinyllama-1.1b/0"]["collectives"] == {
        "all-gather": all_gather, "all-reduce": all_reduce,
        "reduce-scatter": reduce_scatter}
    assert (all_gather, all_reduce, reduce_scatter) == (
        2_768_896, 266_760, 327_680)
    assert records["port"]["tinyllama-1.1b/0"]["replicated_ops"] == {}


def test_the_two_dispatches_are_two_programs(records):
    """deepseek: the default record is the gspmd body's, the switched
    one shard_map's; the shard_map dispatch moves more all-to-all bytes
    in both packages (its pair of all-to-alls against the gspmd body's
    reduce-scatter and gathers in the port, against XLA's gathers in the
    reference), and the gspmd buffer and its output take
    ``moe_buffer``'s layout: experts over ``model``, capacity over
    ``data``."""
    port, ref = records["port"], records["reference"]
    g, m = port["deepseek-v3-671b/0"], port["deepseek-v3-671b/1"]
    assert g["collectives"] != m["collectives"]
    a2a = {k: r["collectives"].get("all-to-all", 0) for k, r in (
        ("port gspmd", g), ("port shard_map", m),
        ("ref gspmd", ref["deepseek-v3-671b/0"]),
        ("ref shard_map", ref["deepseek-v3-671b/1"]))}
    assert a2a["port shard_map"] > a2a["port gspmd"]
    assert a2a["ref shard_map"] > a2a["ref gspmd"] > 0
    n_moe = 2 * (t_base.get("deepseek-v3-671b").smoke_config().n_layers
                 - 1)                      # buffer and output a layer
    buf = [h for h in g["hints"] if h["name"] == "moe_buffer"]
    assert len([h for h in buf if h["phase"] == "forward"]) == n_moe
    assert all(_tuple(h["out"]) == ("Shard(1)", "Shard(0)") for h in buf)
    assert not [h for h in m["hints"] if h["name"] == "moe_buffer"]
    for r in (g, m):
        assert r["replicated_ops"] == {}
        assert all(_tuple(h["out"]) == SEQ_SHARDED for h in r["hints"]
                   if h["name"] == "lm_activations")


def test_tinyllama_moves_fewer_bytes_than_before_the_hints(records):
    """The parent's trace of the same cell, without the hints
    (DTensor's own placements): all-gather 7 348 224, all-reduce 487 944,
    reduce-scatter 782 336 B a device under torch 2.13.  The pinned
    stream moves less of each kind; the reference's compile has the
    same order of bytes (XLA's choices are its own)."""
    got = records["port"]["tinyllama-1.1b/0"]["collectives"]
    before = {"all-gather": 7_348_224, "all-reduce": 487_944,
              "reduce-scatter": 782_336}
    assert all(got[k] < v for k, v in before.items())
    ref = records["reference"]["tinyllama-1.1b/0"]["collectives"]
    total = sum(got.values())
    assert 0.5 < total / sum(ref.values()) < 2


_LOCAL = textwrap.dedent("""
    import sys
    import numpy as np, torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.placement_types import _StridedShard
    from repro_torch.distrib import hints as H
    from repro_torch.distrib import sharding as S
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    pm = S.DeviceMesh(["meta"] * 8, (2, 4), ("data", "model"))
    R = Replicate()

    def rank0(t):
        return t._local_tensors[0] if hasattr(t, "_local_tensors") else t

    def err(a, b):
        return float((rank0(a) - b).abs().max() / (b.abs().max() + 1e-30))

    worst = 0.0
    rng = np.random.default_rng(0)
    # the gspmd body: each expert layout the dry run gives it
    layouts = {
        # deepseek: experts over model, capacity over data
        "ep": (8, [Shard(1), Shard(0)], [Shard(2), Shard(0)],
               S.P("model", "data", None)),
        # mixtral: experts whole, the width over model, capacity over data
        "tp": (4, [Shard(1), Shard(2)], [Shard(2), Shard(1)],
               S.P(None, "data", None)),
        # no hint: the buffer whole on every device
        "none": (8, [Shard(1), Shard(0)], [Shard(2), Shard(0)], None)}
    for name, (e, gate_pl, down_pl, spec) in layouts.items():
        cfg = M.MoEConfig(n_experts=e, top_k=2, d_ff_expert=12, n_shared=1,
                          capacity_factor=0.9)
        p = {k: v[0] for k, v in M.init_moe_params(
            rng, cfg, 16, 1, torch.float32, "cpu").items()}
        x = torch.tensor(rng.standard_normal((64, 16)), dtype=torch.float32)
        xr = x.clone().requires_grad_(True)
        pr = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        yr, ar = M.moe_ffn(pr, xr, cfg)
        ((yr * yr).sum() + ar).backward()
        hints = {"mesh": pm}
        if spec is not None:
            hints["moe_buffer"] = S.NamedSharding(pm, spec)
        with LocalTensorMode(8):
            mesh = init_device_mesh("cpu", (2, 4),
                                    mesh_dim_names=("data", "model"))
            pls = {"w_gate": gate_pl, "w_up": gate_pl, "w_down": down_pl,
                   "router": [Shard(0), R], "shared_gate": [Shard(0),
                                                            Shard(1)],
                   "shared_up": [Shard(0), Shard(1)],
                   "shared_down": [R, Shard(0)]}
            pd = {k: distribute_tensor(v, mesh, pls[k]).requires_grad_(True)
                  for k, v in p.items()}
            xd = distribute_tensor(x, mesh, [Shard(0), R]).requires_grad_(
                True)
            with H.hints_ctx(hints):
                y, aux = M.moe_ffn(pd, xd, cfg)
                ((y * y).sum() + aux).backward()
            worst = max(worst, err(y.full_tensor(), yr.detach()),
                        err(aux.full_tensor(), ar.detach()),
                        err(xd.grad.full_tensor(), xr.grad),
                        *(err(pd[k].grad.full_tensor(), pr[k].grad)
                          for k in p))
    # layers.linear: rows split (the pinned stream), a strided row split
    # (a reshape of it), the width split (column- then row-parallel)
    x = torch.tensor(rng.standard_normal((8, 16, 12)), dtype=torch.float32)
    w1 = torch.tensor(rng.standard_normal((12, 20)), dtype=torch.float32)
    w2 = torch.tensor(rng.standard_normal((20, 12)), dtype=torch.float32)
    xr, w1r, w2r = (t.clone().requires_grad_(True) for t in (x, w1, w2))
    ref = L.linear(torch.relu(L.linear(xr, w1r)), w2r)
    ref.square().sum().backward()
    for x_pl, flat in (([Shard(0), Shard(1)], False),
                       ([Shard(0), R], False), ([Shard(0), Shard(1)], True)):
        with LocalTensorMode(8):
            mesh = init_device_mesh("cpu", (2, 4),
                                    mesh_dim_names=("data", "model"))
            xd = distribute_tensor(x, mesh, x_pl).requires_grad_(True)
            w1d = distribute_tensor(w1, mesh, [Shard(0), Shard(1)]
                                    ).requires_grad_(True)
            w2d = distribute_tensor(w2, mesh, [Shard(1), Shard(0)]
                                    ).requires_grad_(True)
            xin = xd.reshape(128, 12) if flat else xd
            if flat:
                assert isinstance(xin.placements[1], _StridedShard)
            out = L.linear(torch.relu(L.linear(xin, w1d)), w2d)
            out.square().sum().backward()
            out = out.full_tensor().reshape(ref.shape)
            worst = max(worst, err(out, ref.detach()),
                        err(xd.grad.full_tensor(), xr.grad),
                        err(w1d.grad.full_tensor(), w1r.grad),
                        err(w2d.grad.full_tensor(), w2r.grad))
    print("WORST", worst)
""")


def test_gspmd_body_and_linear_equal_one_device_on_local_ranks():
    """Values and gradients on eight LocalTensor ranks against one
    device, within 1e-5 of each tensor's largest magnitude (float32
    sums in another order; capacity factor 0.9, so tokens drop, and the
    drops must agree: they come from the global ranks)."""
    r = subprocess.run([sys.executable, "-c", _LOCAL], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stderr[-3000:]
    worst = float(r.stdout.split("WORST")[-1])
    assert worst < 1e-5, worst


def test_hints_change_no_bit_on_plain_tensors():
    """The bundle's hints installed (a (2, 4) mesh's, ``moe_buffer``
    and ``attn_q`` too) against none: deepseek's smoke training loss and
    gradients on the CPU are the same bits."""
    cfg = dataclasses.replace(
        t_base.get("deepseek-v3-671b").smoke_config(), n_layers=2)
    mesh = t_sh.DeviceMesh(["meta"] * 8, MESH, ("data", "model"))
    t_lm.LM_SHAPES["hints_probe"] = SHAPE
    try:
        hints = t_lm.bundle(cfg, "hints_probe", mesh, mode="mem").hints
    finally:
        del t_lm.LM_SHAPES["hints_probe"]
    assert {"lm_activations", "attn_q", "moe_buffer", "mesh"} <= set(hints)
    rng = np.random.default_rng(3)
    tok = torch.tensor(rng.integers(0, cfg.vocab, (2, 32)))

    def run():
        params = t_tf.init_params(cfg, seed=0, device="cpu")
        for t in leaves(params):
            t.requires_grad_(True)
        loss = t_tf.train_loss(params, cfg, tok, tok.roll(-1, 1),
                               torch.ones_like(tok))
        loss.backward()
        return [loss.detach()] + [t.grad for t in leaves(params)]

    plain = run()
    with t_hints.hints_ctx(hints):
        hinted = run()
    assert all(torch.equal(a, b) for a, b in zip(plain, hinted))
