"""The port's dry run (ROADMAP item 7d) against the JAX package's bundles.

One subprocess builds every JAX ``dryrun_bundle`` (both probe modes) on
512 forced host devices and emits, per cell and argument leaf, the path,
shape, dtype, spec and ``NamedSharding.shard_shape``; the port's
bundles must give the same trees, the same donated arguments, the same
``meta`` (less the reference's ``l1_bundle``) and the same per-device
argument and alias bytes, for every runnable cell on the smoke, single
and multi meshes, and with ``REPRO_MOE_EP2D`` / ``REPRO_MOE_TPF`` (and MIND's
``REPRO_SHARDED_TOPK``) set.
A few full-width cells are traced on fake tensors (``launch.dryrun``,
each in a process of its own, since the fake process group is global
to its process) to ``status: "ok"`` with every record field; deepseek
at the depth of the reference's cost probe (its 3 dense and 4 MoE
layers), so that the file takes tens of seconds (``chip_smoke.py``
phase 17 traces all 61).  On the
smoke config's train step the tracker's peak on fake tensors equals its
peak on real CPU tensors, and its FLOPs equal ``FlopCounterMode``'s
eager count.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)

from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

_JAX_BUNDLES = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json, sys
    sys.path.insert(0, "src")
    import jax, numpy as np
    from jax.sharding import NamedSharding
    from repro.configs import base
    from repro.launch.mesh import make_production_mesh, make_smoke_mesh

    def path_str(path):
        return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)

    def emit(b):
        flat = jax.tree_util.tree_flatten_with_path(b.args)[0]
        shs = jax.tree.leaves(b.in_shardings,
                              is_leaf=lambda x: isinstance(x, NamedSharding))
        assert len(flat) == len(shs)
        args, total, alias = [], 0, 0
        for (path, a), sh in zip(flat, shs):
            ss = sh.shard_shape(tuple(a.shape))
            n = int(np.prod(ss)) * np.dtype(a.dtype).itemsize
            total += n
            if int(path_str(path).split("/")[0]) in b.donate_argnums:
                alias += n
            spec = [list(e) if isinstance(e, tuple) else e for e in sh.spec]
            spec += [None] * (len(a.shape) - len(spec))
            args.append([path_str(path), list(a.shape), str(a.dtype), spec,
                         list(ss)])
        meta = {k: v for k, v in b.meta.items() if k != "l1_bundle"}
        return {"args": args, "donate": list(b.donate_argnums),
                "meta": meta, "arg_bytes": total, "alias_bytes": alias}

    meshes = {"smoke": make_smoke_mesh(), "single": make_production_mesh(),
              "multi": make_production_mesh(multi_pod=True)}
    out = {}
    for mname, mesh in meshes.items():
        for arch in base.ALL_ARCHS:
            mod = base.get(arch)
            for shape in mod.SHAPES:
                if shape in mod.SKIPS:
                    continue
                for mode in ("cost", "mem"):
                    out[f"{mname}/{arch}/{shape}/{mode}"] = emit(
                        mod.dryrun_bundle(shape, mesh, mode=mode))
    for var in ("REPRO_MOE_EP2D", "REPRO_MOE_TPF"):
        os.environ[var] = "1"
        for arch in ("deepseek-v3-671b", "mixtral-8x22b"):
            out[f"single/{arch}/train_4k/mem/{var}"] = emit(
                base.get(arch).dryrun_bundle("train_4k", meshes["single"],
                                             mode="mem"))
        del os.environ[var]
    os.environ["REPRO_SHARDED_TOPK"] = "1"
    out["single/mind/retrieval_cand/mem/REPRO_SHARDED_TOPK"] = emit(
        base.get("mind").dryrun_bundle("retrieval_cand", meshes["single"],
                                       mode="mem"))
    del os.environ["REPRO_SHARDED_TOPK"]
    print(json.dumps(out))
""")

#: the full-width cells traced to ``ok``: (arch, shape, mesh), and a
#: switch set to 1 where a fourth entry names it
TRACED = [("tinyllama-1.1b", "train_4k", "single"),
          ("deepseek-v3-671b", "train_4k", "single"),
          ("mixtral-8x22b", "decode_32k", "multi"),
          ("wide-deep", "train_batch", "single"),
          ("graphsage-reddit", "ogb_products", "single"),
          ("mind", "retrieval_cand", "single"),
          ("mind", "retrieval_cand", "single", "REPRO_SHARDED_TOPK")]


#: traced depth where it is cut: the reference's cost-probe depth
_DEPTH = {"deepseek-v3-671b": 7}
_TRACE = """
import dataclasses, sys
from repro_torch.configs import base
from repro_torch.launch import dryrun
arch, shape, mesh, out = sys.argv[1:]
if {depth}:
    mod = base.get(arch)
    full = mod.model_config
    mod.model_config = lambda: dataclasses.replace(full(), n_layers={depth})
dryrun.main(["--arch", arch, "--shape", shape, "--mesh", mesh, "--out", out])
"""


@pytest.fixture(scope="module")
def jax_bundles():
    r = subprocess.run([sys.executable, "-c", _JAX_BUNDLES],
                       capture_output=True, text=True, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The TRACED cells' records, each traced by the CLI in a process of
    its own (with its switch set), into a directory of its own, all
    started together."""
    out = tmp_path_factory.mktemp("dryrun")
    procs = []
    for cell in TRACED:
        a, s, m = cell[:3]
        env = dict(os.environ, PYTHONPATH=SRC,
                   **{v: "1" for v in cell[3:]})
        d = out / "__".join(cell)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _TRACE.format(depth=_DEPTH.get(a, 0)), a,
             s, m, str(d)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    logs = [p.communicate(timeout=900) for p in procs]
    for p, (so, se) in zip(procs, logs):
        assert p.returncode == 0, so + se[-3000:]
    return {cell: json.load(open(out / "__".join(cell)
                                 / ("__".join(cell[:3]) + ".json")))
            for cell in TRACED}


def _emit(bundle) -> dict:
    args = []
    for i, (arg, sh) in enumerate(zip(bundle.args, bundle.in_shardings)):
        for (path, t), s in zip(leaves_with_paths(arg),
                                dryrun._flat_shardings(arg, sh)):
            spec = [list(e) if isinstance(e, tuple) else e for e in s.spec]
            spec += [None] * (t.dim() - len(spec))
            args.append(["/".join(str(p) for p in (i,) + path),
                         list(t.shape), str(t.dtype).replace("torch.", ""),
                         spec, list(s.shard_shape(t.shape))])
    total, alias = dryrun.argument_bytes(bundle)
    meta = {k: v for k, v in bundle.meta.items() if k != "l1_bundle"}
    return {"args": args, "donate": list(bundle.donate_argnums),
            "meta": json.loads(json.dumps(meta)), "arg_bytes": total,
            "alias_bytes": alias}


_MESHES = {"smoke": t_mesh.make_smoke_mesh(),
           "single": t_mesh.make_production_mesh(),
           "multi": t_mesh.make_production_mesh(multi_pod=True)}


@pytest.mark.parametrize("arch", t_base.ALL_ARCHS)
def test_bundles_equal_the_reference(jax_bundles, arch):
    """Spec trees, argument shapes and dtypes in both modes, donated
    arguments, meta and per-device argument and alias bytes of every
    runnable cell of ``arch`` on the three meshes."""
    mod = t_base.get(arch)
    n = 0
    for mname, mesh in _MESHES.items():
        for shape in mod.SHAPES:
            if shape in mod.SKIPS:
                continue
            for mode in ("cost", "mem"):
                key = f"{mname}/{arch}/{shape}/{mode}"
                assert _emit(mod.dryrun_bundle(shape, mesh, mode=mode)) \
                    == jax_bundles[key], key
                n += 1
    assert n == 3 * 2 * (len(mod.SHAPES) - len(mod.SKIPS))


def test_sharded_topk_switch_equals_the_reference(jax_bundles, monkeypatch):
    monkeypatch.setenv("REPRO_SHARDED_TOPK", "1")
    got = _emit(t_base.get("mind").dryrun_bundle(
        "retrieval_cand", _MESHES["single"], mode="mem"))
    assert got == jax_bundles[
        "single/mind/retrieval_cand/mem/REPRO_SHARDED_TOPK"]


@pytest.mark.parametrize("var", ["REPRO_MOE_EP2D", "REPRO_MOE_TPF"])
def test_moe_layout_switches_equal_the_reference(jax_bundles, var,
                                                 monkeypatch):
    monkeypatch.setenv(var, "1")
    for arch in ("deepseek-v3-671b", "mixtral-8x22b"):
        got = _emit(t_base.get(arch).dryrun_bundle(
            "train_4k", _MESHES["single"], mode="mem"))
        assert got == jax_bundles[f"single/{arch}/train_4k/mem/{var}"], arch


def test_every_runnable_cell_is_counted(jax_bundles):
    """36 runnable cells an arch set: 72 on the two production meshes,
    4 long_500k skips on each."""
    runnable = [(a, s) for a in t_base.ALL_ARCHS for s in t_base.get(a).SHAPES
                if s not in t_base.get(a).SKIPS]
    assert len(runnable) == 36
    assert sum(len(t_base.get(a).SKIPS) for a in t_base.ALL_ARCHS) == 4
    assert sum(k.startswith(("single/", "multi/")) and k.endswith("/mem")
               for k in jax_bundles) == 72


_FIELDS = {"arch", "shape", "mesh", "status", "n_chips", "probe",
           "mem_probe_s", "cost_probe_s", "memory", "collectives",
           "collective_bytes_per_device", "roofline", "replicated_ops",
           "meta"}


@pytest.mark.parametrize("cell", TRACED, ids=["__".join(c) for c in TRACED])
def test_full_width_cell_traces_ok(traced, cell):
    rec = traced[cell]
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert _FIELDS <= set(rec)
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "alias_bytes", "peak_estimate_bytes", "fits_hbm"}
    assert mem["peak_estimate_bytes"] >= mem["argument_bytes"] > 0
    assert mem["temp_bytes"] >= 0
    assert rec["collective_bytes_per_device"] == sum(
        rec["collectives"].values()) > 0
    assert rec["n_chips"] == (512 if cell[2] == "multi" else 256)
    if cell[2] == "multi":
        assert "cost" not in rec and "note" in rec["roofline"]
    else:
        assert rec["cost"]["flops_per_device"] > 0
        assert rec["cost"]["bytes_per_device"] > 0
        r = rec["roofline"]
        assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
        assert {"model_flops", "useful_flops_frac",
                "roofline_fraction"} <= set(r)
        # each device's own ops, not the global step's (the GNN's node
        # products are replicated, as the reference lays them)
        assert rec["cost"]["flops_per_device"] < r["model_flops"]
        if cell[0] == "tinyllama-1.1b":
            assert rec["cost"]["flops_per_device"] < r["model_flops"] / 16


def test_traced_argument_bytes_equal_the_shard_shapes(traced, monkeypatch):
    for cell, rec in traced.items():
        arch, shape, mesh = cell[:3]
        mod = t_base.get(arch)
        if arch in _DEPTH:
            full = mod.model_config()
            monkeypatch.setattr(mod, "model_config", lambda: dataclasses.replace(
                full, n_layers=_DEPTH[arch]))
        bundle = mod.dryrun_bundle(shape, _MESHES[mesh], mode="mem")
        assert rec["memory"]["argument_bytes"] == \
            dryrun.argument_bytes(bundle)[0], (arch, shape, mesh)


def test_sharded_topk_gathers_the_survivors_alone(traced):
    """MIND's retrieval on the 16 x 16 mesh: the top-k gathers the
    (B, N) float32 scores whole, or with ``REPRO_SHARDED_TOPK=1`` each
    ``model`` shard's (B, k) values and int32 ids alone; every other
    collective (the history's table lookup among them) is the same."""
    from repro_torch.configs import recsys_common as RC
    sh = RC.RECSYS_SHAPES["retrieval_cand"]
    b, k = sh["batch"], sh["k"]
    n = t_base.get("mind").model_config().item_vocab
    shards = _MESHES["single"].shape["model"]
    base = traced[("mind", "retrieval_cand", "single")]
    sw = traced[("mind", "retrieval_cand", "single", "REPRO_SHARDED_TOPK")]
    assert base["status"] == sw["status"] == "ok"
    scores, survivors = b * n * 4, shards * b * k * (4 + 4)
    assert (b, n, k, shards) == (1, 1_000_000, 1000, 16)
    got, want = sw["collectives"], base["collectives"]
    assert got["all-gather"] == want["all-gather"] - scores + survivors
    assert survivors == 128_000 < scores
    assert {c: v for c, v in got.items() if c != "all-gather"} == {
        c: v for c, v in want.items() if c != "all-gather"}


def test_donated_outputs_alias_and_train_fits(traced):
    rec = traced[("tinyllama-1.1b", "train_4k", "single")]
    mem = rec["memory"]
    # parameters and moments are updated in place, so every donated byte
    # aliases an output but the step counter's 4 (a new 0-d tensor); the
    # batch's three (256, 4096) int32 arrays are not donated
    batch = 3 * 4 * 256 * 4096 // 16
    assert mem["argument_bytes"] - mem["alias_bytes"] == batch + 4
    assert mem["fits_hbm"]


def _smoke_train_step(device, fake: bool):
    """tinyllama's smoke config: parameters, optimizer state and one
    batch, and the training CLI's step."""
    from repro_torch.configs import tinyllama_1_1b as cfgmod
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    cfg = cfgmod.smoke_config()
    step = train.make_step(train._lm_loss, cfg, adamw.AdamWConfig())

    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (2, 64), generator=g)
    real_batch = {"tokens": tok, "targets": tok.roll(-1, 1),
                  "mask": torch.ones_like(tok)}

    def make():
        if fake:
            params = t_base.abstract_tree(T.init_params(cfg, abstract=True))
            batch = {k: t_base.fake_mode().from_tensor(v)
                     for k, v in real_batch.items()}
        else:
            params = T.init_params(cfg, seed=0, device=device)
            batch = {k: v.clone() for k, v in real_batch.items()}
        return params, adamw.init_opt_state(params), batch
    return step, make


def test_tracker_peak_and_flops_fake_equal_real():
    step, make_real = _smoke_train_step("cpu", fake=False)
    real = dryrun.trace(step, make_real, donate_argnums=(0, 1))
    _, make_fake = _smoke_train_step("cpu", fake=True)
    with t_base.fake_mode():
        fake = dryrun.trace(step, make_fake, donate_argnums=(0, 1))
    assert fake["memory"] == real["memory"]
    assert fake["flops"] == real["flops"] > 0
    assert fake["collectives"] == real["collectives"] == {}
    from torch.utils.flop_counter import FlopCounterMode
    params, opt, batch = make_real()
    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
    assert fc.get_total_flops() == real["flops"]


def test_smoke_mesh_has_no_collectives():
    mod = t_base.get("bst")
    rec = dryrun.trace_bundle(mod.dryrun_bundle("serve_p99",
                                                t_mesh.make_smoke_mesh()),
                              t_mesh.make_smoke_mesh())
    assert rec["collectives"] == {} and rec["replicated_ops"] == {}
    assert rec["flops"] > 0


def test_hw_is_the_h100_datasheet():
    assert t_mesh.HW == {"peak_flops_bf16": 989.4e12, "hbm_bw": 3.35e12,
                         "ib_bw": 50e9, "hbm_bytes": 80 * 2 ** 30}
    m = t_mesh.make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert {d.type for d in m.devices.flat} == {"meta"}


def test_refused_view_gathers_only_the_reshaped_dims():
    """A split of an unevenly sharded dim (4 key/value heads of 64 in a
    feature dim sharded 16 ways), which some torch versions refuse, is
    retried with that dim gathered and the batch left sharded."""
    script = textwrap.dedent("""
        import torch
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        from repro_torch.configs import base
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh
        tm = dryrun.torch_mesh(make_production_mesh())
        view = torch.ops.aten.view.default
        with base.fake_mode(), implicit_replication(), \\
                dryrun.Tracker() as tr:
            x = DTensor.from_local(
                torch.empty(16, 64, 16), tm, [Shard(0), Shard(2)],
                run_check=False, shape=(256, 64, 256),
                stride=(64 * 256, 256, 1))
            y = tr._regathered_view(view, (x, [256, 64, 4, 64]), {})
            assert tuple(y.placements) == (Shard(0), Replicate())
            assert tuple(y._local_tensor.shape) == (16, 64, 4, 64)
            # the gathered block at least (DTensor may stage the gather)
            assert set(tr.collectives) == {"all-gather"}
            assert tr.collectives["all-gather"] >= 16 * 64 * 256 * 4
            assert tr._regathered_view(view, (y, [256, 64, 4, 64]),
                                       {}) is None
        print("VIEW_OK")
    """)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, cwd=ROOT, timeout=300,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert "VIEW_OK" in r.stdout, r.stderr[-3000:]
