"""The benchmark stands apart: no module under ``portbench/`` imports
JAX, the JAX package or the JAX benchmarks, and the reference imports
nothing of the port.  Names are compared by their whole top-level part,
so ``repro_torch`` is not taken for ``repro``."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _modules():
    return sorted(p for p in HERE.rglob("*.py")
                  if "__pycache__" not in p.parts)


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_every_module_is_scanned():
    names = {p.relative_to(HERE).as_posix() for p in _modules()}
    assert {"run.py", "bench.py", "port.py", "traffic.py", "check.py",
            "reference/retrieval.py", "metrics/latency_p95_ms.py"} <= names


def test_no_jax_no_jax_package_no_jax_benchmarks():
    bad = {(p.relative_to(HERE).as_posix(), m) for p in _modules()
           for m in _imported(p) if m in FORBIDDEN}
    assert not bad, bad


def test_reference_imports_nothing_of_the_port():
    ref = [p for p in _modules() if "reference" in p.parts]
    assert len(ref) >= 5
    bad = {(p.name, m) for p in ref for m in _imported(p)
           if m == "repro_torch" or m in FORBIDDEN}
    assert not bad, bad
    # nor any module of the benchmark that does (port.py)
    for p in ref:
        assert "portbench.port" not in p.read_text(), p


def test_whole_name_comparison():
    assert "repro_torch" not in FORBIDDEN
    assert "repro_torch".split(".")[0] != "repro"
