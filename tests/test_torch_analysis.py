"""The port's invariant analyzer (``src/repro_torch/analysis``): each pass
flags the calls it should on seeded sources and spares exempt scopes,
the committed port baseline keeps ``src/repro_torch`` green with a note
on every entry, the baseline is a ratchet, the JAX package's analyzer
still finds nothing in the port, and the runtime sanitizers behave on
the CPU (``no_syncs`` needs a card: its card cases are in
``tests/test_torch_gpu.py``)."""

import json
import os
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro.analysis import analyze_paths as j_analyze_paths
from repro.analysis.__main__ import main as j_main
from repro_torch import analysis
from repro_torch.analysis import findings as F
from repro_torch.analysis import sanitizers as S
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.serving.admission import AdmissionConfig, AdmissionQueue

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = "src/repro_torch/serving/engine.py"


def _hostsync(src, path=ENGINE):
    return [(f.invariant, f.scope, f.code) for f in analysis.analyze_source(
        textwrap.dedent(src), path, passes={"hostsync"})]


# ------------------------------------------------------------ hostsync --

FLAGGED = [
    ("torch.cuda.synchronize()", "hostsync/blocking-sync"),
    ("stream.synchronize()", "hostsync/blocking-sync"),
    ("fence(self.device)", "hostsync/blocking-sync"),
    ("x.item()", "hostsync/device-to-host"),
    ("x.tolist()", "hostsync/device-to-host"),
    ("x.cpu()", "hostsync/device-to-host"),
    ("x.numpy()", "hostsync/device-to-host"),
    ("torch.tensor(theta, device=x.device)", "hostsync/host-to-device"),
    ("torch.as_tensor(v, device='cuda')", "hostsync/host-to-device"),
    ("torch.from_numpy(a).to(self.device)", "hostsync/host-to-device"),
    ("torch.from_numpy(a).cuda()", "hostsync/host-to-device"),
    ("torch.from_numpy(a).pin_memory().to(dev)", "hostsync/host-to-device"),
    ("torch.tensor([1, 2]).long().to(dev, torch.int32)",
     "hostsync/host-to-device"),
]


@pytest.mark.parametrize("call,invariant", FLAGGED)
def test_hostsync_flags_each_sync_in_a_hot_scope(call, invariant):
    src = f"""
        class ServingEngine:
            def serve(self, x, a, v, theta, stream, dev):
                return {call}
    """
    assert _hostsync(src) == [(invariant, "ServingEngine.serve", call)]


SPARED = [
    "torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)",
    "torch.from_numpy(a).to(torch.float32)",
    "torch.tensor(v, dtype=torch.int32)",
    "torch.as_tensor(v, device='cpu')",
    "torch.full((4,), 1.0, device=dev)",
    "x.to(dev)",
    "self.item",
]


@pytest.mark.parametrize("expr", SPARED)
def test_hostsync_spares_calls_that_do_not_wait(expr):
    src = f"""
        class ServingEngine:
            def serve(self, x, a, v, dev):
                return {expr}
    """
    assert _hostsync(src) == []


def test_hostsync_tracks_host_names_and_folds_cpu_numpy():
    src = """
        def _stage(a, dev, ranked):
            t = torch.from_numpy(a)
            u = t.long()
            ok = t.pin_memory().to(dev, non_blocking=True)
            return u.to(dev), ranked.cpu().numpy()
    """
    assert _hostsync(src) == [
        ("hostsync/host-to-device", "_stage", "u.to(dev)"),
        ("hostsync/device-to-host", "_stage", "ranked.cpu().numpy()")]


@pytest.mark.parametrize("path,scope,hot", [
    (ENGINE, "__init__", False),
    (ENGINE, "warmup", False),
    (ENGINE, "_timed", True),
    ("src/repro_torch/serving/service.py", "_run_batch", True),
    ("src/repro_torch/serving/service.py", "submit", False),
    ("src/repro_torch/serving/sched/scheduler.py", "_chunk_step", True),
    ("src/repro_torch/serving/sched/scheduler.py", "_refill_step", False),
    ("src/repro_torch/kernels/topk/ops.py", "anything", True),
    ("src/repro_torch/obs/trace.py", "record", True),
    ("src/repro_torch/obs/device.py", "resolve", True),
    ("src/repro_torch/obs/export.py", "write", False),
    ("src/repro_torch/models/transformer.py", "decode_step", True),
    ("src/repro_torch/models/transformer.py", "prefill", False),
    ("src/repro_torch/models/attention.py", "decode_attention", True),
    ("src/repro_torch/models/layers.py", "rope", True),
    ("src/repro_torch/models/layers.py", "chunked_softmax_xent", False),
    ("src/repro_torch/core/cascade.py", "predict", False),
    ("src/repro_torch/serving/funnel.py", "execute", True),
    ("src/repro_torch/serving/funnel.py", "_stage_funnel", True),
    ("src/repro_torch/serving/funnel.py", "funnel_gold_runs", False),
])
def test_hostsync_hot_scopes_and_exemptions(path, scope, hot):
    src = f"""
        def {scope}(x):
            return x.item()
    """
    assert bool(_hostsync(src, path)) is hot


def test_hostsync_reports_the_last_line_of_a_multiline_call():
    tree = __import__("ast").parse(textwrap.dedent("""
        def decode_step(x):
            return (x
                    .sum()
                    .item())
    """))
    ((finding, end),) = analysis.hostsync.scan(
        tree, "src/repro_torch/models/transformer.py")
    assert (finding.line, end) == (3, 5)


# --------------------------------------------------------------- locks --

SEED_LOCKS = textwrap.dedent("""
    import threading

    class MetricsRegistry:
        def __init__(self):
            self._lock = threading.Lock()
            self._metrics = {}

        def get(self, name):
            return self._metrics[name]

        def put(self, name, m):
            with self._lock:
                self._metrics[name] = m

        def counters(self):
            return dict(self._metrics)
""")


def test_locks_pass_flags_unguarded_reads_and_spares_exemptions():
    found = analysis.analyze_source(SEED_LOCKS, "m.py", passes={"locks"})
    assert [(f.invariant, f.scope, f.code) for f in found] == [
        ("locks/unguarded", "MetricsRegistry.get", "self._metrics (read)")]


def test_locks_registry_is_the_references():
    """The reference's registry in its order, then the port's own
    entries: the captured program's lock and the program cache's."""
    from repro.analysis.locks import LOCK_REGISTRY as J_REGISTRY
    n = len(J_REGISTRY)
    assert S.LOCK_REGISTRY[:n] == tuple(
        S.LOCK_REGISTRY[0].__class__(**vars(s)) for s in J_REGISTRY)
    assert [s.cls for s in S.LOCK_REGISTRY[n:]] == [
        "GraphProgram", "ProgramCache"]


# ----------------------------------------------------------- recompile --

#: an engine that hands ``_stage`` to its program cache; each case adds
#: the stage (and any helper) below it
CAPTURE_HEAD = """
import numpy as np
import torch


class Engine:
    def serve(self, timings, x, v):
        return self._timed(timings, "s_ms", "s", _stage, x, v, depth=4)
"""

#: (rule, a source that breaks it, its clean twin)
RECOMPILE_CASES = [
    ("captured-branch", """
def _stage(x, v, *, depth):
    if v.sum() > 0:
        return x
    return -x
""", """
def _stage(x, v, *, depth):
    if depth > 2:
        return torch.where(v.sum() > 0, x, -x)
    return -x
"""),
    ("captured-branch", """
def _stage(x, v, *, depth):
    return _helper(x, v.amax())


def _helper(x, m):
    return x if m > 0 else -x
""", """
def _stage(x, v, *, depth):
    return _helper(x, depth)


def _helper(x, m):
    return x if m > 0 else -x
"""),
    ("captured-coercion", """
def _stage(x, v, *, depth):
    return x[:, :int(v.max())]
""", """
def _stage(x, v, *, depth):
    return x[:, :int(x.shape[1] // depth)]
"""),
    ("captured-coercion", """
def _stage(x, v, *, depth):
    return x * v.sum().item()
""", """
def _stage(x, v, *, depth):
    if x.device.type == "cpu":
        return x * v.sum().item()
    return x * v.sum()
"""),
    ("captured-coercion", """
def _stage(x, v, *, depth):
    return x * v.sum().item()
""", """
def _stage(x, v, *, depth):
    if is_dtensor(x):
        return x * v.sum().item()
    return x * v.sum()
"""),
    ("host-tensor", """
def _stage(x, v, *, depth):
    return x + torch.tensor([1.0, 2.0], device=x.device)
""", """
def _stage(x, v, *, depth):
    return x + torch.arange(2, device=x.device)
"""),
    ("host-tensor", """
def _stage(x, v, *, depth):
    return x + torch.from_numpy(np.arange(2))
""", """
def _stage(x, v, *, depth):
    return x + torch.full((2,), depth, device=x.device)
"""),
    ("data-dependent-shape", """
def _stage(x, v, *, depth):
    keep = v > 0
    return x[keep]
""", """
def _stage(x, v, *, depth):
    keep = v > 0
    return torch.where(keep, x, torch.zeros_like(x))
"""),
    ("data-dependent-shape", """
def _stage(x, v, *, depth):
    return x.index_select(0, torch.nonzero(v)[:, 0])
""", """
def _stage(x, v, *, depth):
    return x.index_select(0, v.topk(depth).indices)
"""),
    ("data-dependent-shape", """
def _stage(x, v, *, depth):
    return x.repeat_interleave(v, dim=0)
""", """
def _stage(x, v, *, depth):
    return x.repeat_interleave(v, dim=0, output_size=depth)
"""),
    ("captured-cache-key", """
def _stage(x, v, *, depth):
    seen = {}
    seen[v.sum()] = depth
    return x
""", """
def _stage(x, v, *, depth):
    seen = {}
    seen[x.shape] = depth
    return x
"""),
    ("captured-iteration", """
def _stage(x, v, *, depth):
    for row in x:
        v = v + row
    return v
""", """
def _stage(x, v, *, depth):
    for i in range(depth):
        v = v + x[:, i]
    return v
"""),
]

CLOSURE_CASES = [("""
class Engine:
    def serve(self, timings, x, v):
        def stage(v):
            return v + x
        return self._timed(timings, "s_ms", "s", stage, v)
""", """
class Engine:
    def serve(self, timings, x, v):
        def stage(v, x):
            return v + x
        return self._timed(timings, "s_ms", "s", stage, v, x)
"""), ("""
class Engine:
    def serve(self, timings, x):
        return self._timed(timings, "s_ms", "s", self._stage, x)

    def _stage(self, x):
        return x + self.bias
""", """
class Engine:
    def serve(self, timings, x):
        return self._timed(timings, "s_ms", "s", _stage, x, self.bias)


def _stage(x, bias):
    return x + bias
"""), ("""
class Programs:
    def chunk(self, state, pos):
        return self._run("chunk", lambda: state + pos)
""", """
class Programs:
    def chunk(self, state, pos):
        return self._run("chunk", lambda s, p: s + p, state, pos)
""")]


def _recompile(src, path="m.py"):
    return [(f.invariant, f.scope, f.code) for f in analysis.analyze_source(
        textwrap.dedent(src), path, passes={"recompile"})]


@pytest.mark.parametrize("bad", [True, False], ids=["bad", "clean"])
@pytest.mark.parametrize("rule,bad_src,clean_src", [
    pytest.param(rule, b, c, id=f"{rule}-{i}") for i, (rule, b, c) in
    enumerate(RECOMPILE_CASES + [("captured-closure", b, c)
                                 for b, c in CLOSURE_CASES])])
def test_recompile_rule_flags_its_case_and_spares_the_clean_twin(
        rule, bad_src, clean_src, bad):
    """Each ``recompile/*`` rule on a small source that breaks it (only
    that rule's findings) and on its clean twin (none)."""
    head = "" if rule == "captured-closure" else CAPTURE_HEAD
    found = _recompile(head + (bad_src if bad else clean_src))
    if bad:
        assert found and {f[0] for f in found} == {"recompile/" + rule}
    else:
        assert found == []


def test_recompile_finds_the_engines_captured_scopes(monkeypatch):
    """The stages the engine and the scheduler hand to the cache, the
    sharded engine's and scheduler's among them, and their callees
    across the package, are captured; the host methods around them are
    not.  The pass runs in the CLI and the committed baseline keeps it
    green."""
    from repro_torch.analysis import astutil
    monkeypatch.chdir(REPO_ROOT)
    with open(ENGINE) as f:
        tree = __import__("ast").parse(f.read())
    names = {getattr(n, "name", None) for n in
             astutil.find_captured_scopes(tree, ENGINE)}
    assert {"_stage_gather", "_stage1_rho", "_stage1_k", "_stage2",
            "_stage_rerank", "_stage_rerank_dyn", "_depth_mask",
            "_sched_gather", "_sched_refill", "_sched_chunk",
            "_sched_finalize_rho", "_sched_finalize_k"} <= names
    assert {"_shs_gather", "_shs_stage1", "_shs_allgather", "_shs_stage2",
            "_shs_merge", "_shs_rerank", "_sh_gather", "_sh_stage1",
            "_sh_survivors", "_sh_stage2", "_sh_merge", "_sh_rerank",
            "_nest", "_ssched_gather", "_ssched_refill", "_ssched_chunks",
            "_ssched_chunk", "_ssched_finalize", "_install"} <= names
    assert not names & {"_compiled", "serve", "_split", "_flat",
                        "check_overflow", "budget_grid", "gather",
                        "refill"}
    jass = "src/repro_torch/retrieval/jass.py"
    with open(jass) as f:
        tree = __import__("ast").parse(f.read())
    assert "gather_streams" in {getattr(n, "name", None) for n in
                                astutil.find_captured_scopes(tree, jass)}
    assert analysis_main(["src/repro_torch", "--select", "recompile"]) == 0


def test_recompile_finds_the_decode_scopes(monkeypatch):
    """The decode stage ``DecodePrograms`` hands to its cache, and the
    decode step's callees in ``models/`` (both attentions, the ring's
    slot positions, the MoE's local dispatch), are captured; the
    holder's host method and the MoE's DTensor arm (the dry run's) are
    not.  The pass holds them green with the committed baseline."""
    import ast
    from repro_torch.analysis import astutil
    monkeypatch.chdir(REPO_ROOT)
    names = set()
    for f in ("serving/decode.py", "models/transformer.py", "models/moe.py",
              "models/attention.py"):
        path = "src/repro_torch/" + f
        with open(path) as fh:
            tree = ast.parse(fh.read())
        names |= {getattr(n, "name", None) for n in
                  astutil.find_captured_scopes(tree, path)}
    assert {"_stage_decode", "decode_step", "_decode_layers",
            "_decode_attn_gqa", "_decode_attn_mla", "_slot_positions",
            "decode_attention", "moe_ffn", "_local_dispatch",
            "_combine"} <= names
    assert not names & {"__call__", "_moe_sharded", "prefill",
                        "train_loss"}
    assert analysis_main(["src/repro_torch", "--select", "recompile"]) == 0


def test_recompile_finds_the_servers_predict_scopes(monkeypatch):
    """The predict and margin stages the server hands to its program
    cache, and their callees in ``core/`` (features, the cascade, both
    node kinds, the first firing node), are captured; the server's host
    methods are not.  The pass holds them green with the committed
    baseline."""
    import ast
    from repro_torch.analysis import astutil
    monkeypatch.chdir(REPO_ROOT)
    names = set()
    for f in ("serving/pipeline.py", "core/features.py", "core/cascade.py",
              "core/forest.py", "core/mlp.py"):
        path = "src/repro_torch/" + f
        with open(path) as fh:
            tree = ast.parse(fh.read())
        names |= {getattr(n, "name", None) for n in
                  astutil.find_captured_scopes(tree, path)}
    assert {"_stage_predict", "_stage_margin", "query_features",
            "proba0_from_params", "forest_predict_proba",
            "mlp_predict_proba", "classes_from_proba"} <= names
    assert not names & {"predict_classes", "predict_versioned",
                        "predict_margin", "_operands", "swap_predictor",
                        "predict_batched", "train_mlp"}
    assert analysis_main(["src/repro_torch", "--select", "recompile"]) == 0


def test_recompile_finds_the_funnels_scopes(monkeypatch):
    """The stage the funnel hands to its program cache, and its callees
    (the towers, the exact top-k, BST, the attention it reaches, flash's
    launch), are captured; the funnel's host methods, the labelling
    path and flash's DTensor arm are not.  The pass holds them green
    with the committed baseline, which has no entry for the top-k."""
    import ast
    import json
    from repro_torch.analysis import astutil
    monkeypatch.chdir(REPO_ROOT)
    names = set()
    for f in ("serving/funnel.py", "models/recsys/retrieval_tower.py",
              "models/recsys/bst.py", "models/attention.py",
              "kernels/flash_attention/ops.py",
              "kernels/flash_attention/kernel.py"):
        path = "src/repro_torch/" + f
        with open(path) as fh:
            tree = ast.parse(fh.read())
        names |= {getattr(n, "name", None) for n in
                  astutil.find_captured_scopes(tree, path)}
    assert {"_stage_funnel", "retrieve_topk", "score_candidates",
            "top_k", "_first_set", "_bst_scores", "_rank", "bst_logits",
            "flash_attention_bshd", "_launch"} <= names
    assert not names & {"execute", "serve", "predict", "funnel_gold_runs",
                        "label_requests", "_sharded", "_layout"}
    with open("src/repro_torch/analysis/baseline.json") as fh:
        entries = json.load(fh)["entries"]
    assert not [e for e in entries if "retrieval_tower" in e["file"]]
    assert analysis_main(["src/repro_torch", "--select", "recompile"]) == 0


def test_loops_over_parameter_tree_entries_unroll():
    """A loop whose element is read by string key (a list of layers'
    parameter dicts) is a static unroll; a loop over a tensor is still
    flagged, a tensor leaf of the parameter tree too."""
    src = CAPTURE_HEAD + """
def _stage(x, params):
    for lyr in params["mlp"]:
        x = x @ lyr["w"]
    for row in x:
        x = x + row
    for row in params["w"]:
        x = x + row
    return x
"""
    found = [(f.invariant, f.code) for f in analysis.analyze_source(
        src, ENGINE, passes={"recompile"})]
    assert sorted(found) == [("recompile/captured-iteration", "params['w']"),
                             ("recompile/captured-iteration", "x")]


def test_taint_keeps_the_enumerate_index_a_host_int():
    """A loop over a captured list of tensors unrolls: ``enumerate``'s
    index is a Python int, so a branch on it is not captured (the MLP
    node's last-layer test), while a branch on the element still is."""
    src = CAPTURE_HEAD + """
def _stage(x, layers):
    for i, w in enumerate(layers):
        if i + 1 < len(layers):
            x = x @ w
        if w.sum() > 0:
            x = x + 1
    return x
"""
    found = [(f.invariant, f.code) for f in analysis.analyze_source(
        src, ENGINE, passes={"recompile"})]
    assert found == [("recompile/captured-branch", "w.sum() > 0")]


def test_hot_path_holds_the_servers_predict():
    """The predict path's methods and stages are hot scopes; the swap
    and the boot are not."""
    pipeline = "src/repro_torch/serving/pipeline.py"
    for scope, hot in (("predict_classes", True), ("predict_margin", True),
                       ("_stage_predict", True), ("_host", True),
                       ("swap_predictor", False), ("_boot_knob", False)):
        src = f"""
            def {scope}(x):
                return x.item()
        """
        assert bool(_hostsync(src, pipeline)) is hot, scope


# ------------------------------------------------------------- kernels --

KERNEL_HEAD = """
import torch
from repro_torch.kernels import _build

n_launches = 0


def op_plain(x):
    return x + 1
"""

#: a wrapper that keeps every rule, the base of each case below
KERNEL_CLEAN = KERNEL_HEAD + """

def op(x):
    global n_launches
    if x.device.type == "cpu":
        return op_plain(x)
    out = torch.empty_like(x)
    launch = _build.library("op")
    err = launch(x.data_ptr(), out.data_ptr(), _build.stream(x.device))
    _build.check(err, "op")
    if not _build.counted_in_capture(__name__):
        n_launches += 1
    return out
"""

#: (rule, the clean wrapper's text, what replaces it in the bad twin,
#: what replaces it in the clean twin): each twin differs from
#: ``KERNEL_CLEAN`` in one place
KERNEL_CASES = [
    ("launch-unchecked",
     '    _build.check(err, "op")\n', "", '    _build.check(err, "op")\n'),
    ("launch-unchecked",
     "    err = launch(", "    launch(", "    err = launch("),
    ("launch-uncounted",
     "    if not _build.counted_in_capture(__name__):\n"
     "        n_launches += 1\n",
     "    n_launches += 1\n",
     "    if not _build.counted_in_capture(__name__):\n"
     "        n_launches += 1\n"),
    ("fallback-around-launch",
     '    err = launch(x.data_ptr(), out.data_ptr(), '
     '_build.stream(x.device))\n    _build.check(err, "op")\n',
     '    try:\n'
     '        err = launch(x.data_ptr(), out.data_ptr(), '
     '_build.stream(x.device))\n'
     '        _build.check(err, "op")\n'
     '    except RuntimeError:\n'
     '        pass\n',
     '    try:\n'
     '        err = launch(x.data_ptr(), out.data_ptr(), '
     '_build.stream(x.device))\n'
     '        _build.check(err, "op")\n'
     '    except RuntimeError as e:\n'
     '        raise RuntimeError("op failed on the card") from e\n'),
    ("fallback-around-launch",
     '    launch = _build.library("op")\n',
     '    try:\n'
     '        launch = _build.library("op")\n'
     '    except OSError:\n'
     '        return x\n',
     '    try:\n'
     '        launch = _build.library("op")\n'
     '    finally:\n'
     '        pass\n'),
    ("plain-off-cpu",
     '    if x.device.type == "cpu":\n',
     '    if x.device.type != "cuda":\n',
     '    if x.device.type == "cpu" and not x.is_cuda:\n'),
]


def _kernels(src, path="src/repro_torch/kernels/op/kernel.py"):
    return [(f.invariant, f.scope, f.code) for f in analysis.analyze_source(
        textwrap.dedent(src), path, passes={"kernels"})]


def test_kernels_pass_spares_a_wrapper_that_keeps_every_rule():
    assert _kernels(KERNEL_CLEAN) == []


@pytest.mark.parametrize("bad", [True, False], ids=["bad", "clean"])
@pytest.mark.parametrize("rule,old,bad_text,clean_text", [
    pytest.param(*case, id=f"{case[0]}-{i}")
    for i, case in enumerate(KERNEL_CASES)])
def test_kernels_rule_flags_its_case_and_spares_the_clean_twin(
        rule, old, bad_text, clean_text, bad):
    """Each ``kernels/*`` rule on a wrapper that breaks it in one place
    (only that rule's findings, in the launching function) and on its
    clean twin (none)."""
    assert KERNEL_CLEAN.count(old) == 1
    found = _kernels(KERNEL_CLEAN.replace(old, bad_text if bad
                                          else clean_text))
    if bad:
        assert found and {(f[0], f[1]) for f in found} == {
            ("kernels/" + rule, "op")}
    else:
        assert found == []


def test_kernels_plain_off_cpu_follows_a_module_helper():
    """A wrapper that launches through a helper of its module is a
    launching function: its plain version must sit in the CPU arm, as
    ``flash_attention_bshd``'s does around ``_launch``."""
    src = KERNEL_HEAD + """

def _launch(x, out):
    global n_launches
    err = _build.library("op")(x.data_ptr(), out.data_ptr(), 0)
    _build.check(err, "op")
    if not _build.counted_in_capture(__name__):
        n_launches += 1
    return out


def op(x):
    if x.is_cuda:
        return _launch(x, torch.empty_like(x))
    return op_plain(x)


def op_shard(x):
    if not x.is_cuda and x.device.type == "cpu":
        return op_plain(x)
    return op(x)
"""
    assert _kernels(src) == [("kernels/plain-off-cpu", "op", "op_plain(x)")]


def test_kernels_pass_reads_the_ports_four_wrappers(monkeypatch):
    """The pass finds every launching function of the four kernel
    modules (``flash_attention_bshd`` and ``flash_attention_shard``
    through ``_launch``), and nothing to flag in the port's tree, with
    or without the baseline."""
    import ast
    from repro_torch.analysis import kernels as K
    monkeypatch.chdir(REPO_ROOT)
    found = set()
    for name in ("impact_scan", "topk", "flash_attention", "embedding_bag"):
        path = f"src/repro_torch/kernels/{name}/kernel.py"
        with open(path) as fh:
            found |= K._launching(ast.parse(fh.read()))[1]
    assert {"impact_scan", "block_topk", "embedding_bag_kernel", "_launch",
            "flash_attention_bshd", "flash_attention_shard"} <= found
    assert analysis.analyze_paths(["src/repro_torch"],
                                  passes={"kernels"}) == []
    assert analysis_main(["src/repro_torch", "--select", "kernels",
                          "--no-baseline"]) == 0
    assert "kernels" in analysis.ALL_PASSES and len(analysis.ALL_PASSES) == 4


# ------------------------------------------------------------ baseline --

def test_committed_port_baseline_keeps_the_port_green(monkeypatch, capsys):
    monkeypatch.chdir(REPO_ROOT)
    assert analysis_main(["src/repro_torch", "--strict-stale"]) == 0
    assert "0 new" in capsys.readouterr().out
    with open(analysis.DEFAULT_BASELINE) as f:
        entries = json.load(f)["entries"]
    assert entries and all(e.get("note") for e in entries)
    # the port's own analyzer files are not hot and find nothing
    assert analysis.analyze_paths(["src/repro_torch/analysis"]) == []


def test_baseline_ratchet_passes_old_and_fails_new(tmp_path, capsys):
    p = tmp_path / "serving" / "engine.py"
    p.parent.mkdir()
    p.write_text("def serve(x):\n    return x.cpu().numpy()\n")
    bl = tmp_path / "baseline.json"
    assert analysis_main([str(p), "--baseline", str(bl),
                          "--write-baseline"]) == 0
    assert analysis_main([str(p), "--baseline", str(bl)]) == 0
    assert analysis_main([str(p), "--no-baseline"]) == 1
    # one more of the same expression in the same scope is new
    p.write_text("def serve(x):\n    x.cpu().numpy()\n"
                 "    return x.cpu().numpy()\n")
    assert analysis_main([str(p), "--baseline", str(bl)]) == 1
    # a note survives a rewrite; a vetted finding that went is stale
    data = json.loads(bl.read_text())
    data["entries"][0]["note"] = "vetted"
    bl.write_text(json.dumps(data))
    p.write_text("def serve(x):\n    return x\n")
    capsys.readouterr()
    assert analysis_main([str(p), "--baseline", str(bl)]) == 0
    assert "1 stale" in capsys.readouterr().out
    assert analysis_main([str(p), "--baseline", str(bl),
                          "--strict-stale"]) == 1
    allowed, notes = F.load_baseline(bl)
    assert list(notes.values()) == ["vetted"] and sum(allowed.values()) == 1


def test_the_jax_analyzer_finds_nothing_new_in_the_port(monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    assert j_analyze_paths(["src/repro_torch"]) == []
    assert j_main(["src/"]) == 0
    with open("analysis_baseline.json") as f:
        entries = json.load(f)["entries"]
    assert not any("repro_torch" in e["file"] for e in entries)


def test_analyzer_modules_import_neither_torch_nor_port_code():
    import ast
    pkg = os.path.join(REPO_ROOT, "src", "repro_torch", "analysis")
    for name in ("__init__.py", "__main__.py", "astutil.py", "findings.py",
                 "hostsync.py", "locks.py", "recompile.py", "kernels.py"):
        tree = ast.parse(open(os.path.join(pkg, name)).read())
        roots = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert "torch" not in roots, name
        assert all(r.startswith("repro_torch.analysis") for r in roots
                   if r.startswith("repro_torch")), name


# ---------------------------------------------------------- sanitizers --

def test_no_syncs_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        with S.no_syncs():
            pass


def test_vetted_lines_cover_the_baselined_syncs():
    lines = S.vetted_lines()
    assert ("serving/engine.py", "ServingEngine._fence") in lines
    (lo, hi), = lines[("serving/engine.py", "ServingEngine.serve")]
    src = open(os.path.join(S.PORT_ROOT, "serving/engine.py")).read()
    assert ".cpu()" in "\n".join(src.splitlines()[lo - 1:hi])
    assert ("device.py", "fence") in S.VETTED_HELPERS


class _TwoLocks:
    def __init__(self):
        self._lock = threading.Lock()


def _run(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive()


def test_lock_order_detects_an_inversion_and_passes_nesting():
    a, b = _TwoLocks(), _TwoLocks()

    def nest(x, y):
        def f():
            with x._lock:
                with y._lock:
                    pass
        return f

    with S.lock_order(extra=[(a, "_lock"), (b, "_lock")]) as graph:
        _run(nest(a, b))
        _run(nest(a, b))
    assert graph.cycles() == []
    with pytest.raises(S.LockOrderError, match="deadlock potential"):
        with S.lock_order(extra=[(a, "_lock"), (b, "_lock")]):
            _run(nest(a, b))
            _run(nest(b, a))


def test_lock_order_uses_the_registry_on_the_ports_queue():
    q = AdmissionQueue(AdmissionConfig(max_batch=4, pad_multiple=4))
    with S.lock_order(q) as graph:
        q.submit(np.zeros(3), now=0.0)
        q.flush(now=1.0)
        assert q.poll(now=1.0) is not None
    assert graph.cycles() == []
    with pytest.raises(TypeError, match="LOCK_REGISTRY"):
        with S.lock_order(object()):
            pass
