"""No module of the benchmark imports JAX or the JAX package ``repro``
(whole top-level names: ``repro_torch`` is the port), the references
import nothing of the port, and nothing reads the JAX package's
``benchmarks`` folder."""
import ast
from pathlib import Path

from portbench.tests import smoke  # noqa: F401
from portbench import bench

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules(root: Path):
    for path in sorted(root.rglob("*.py")):
        if "tests" in path.relative_to(bench.PKG).parts:
            continue
        yield path, ast.parse(path.read_text(), filename=str(path))


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_reference_package():
    bad = [(p.name, m) for p, t in _modules(bench.PKG)
           for m in _imported(t) if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_check_compares_whole_names():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN


def test_references_import_nothing_of_the_port():
    for path, tree in _modules(bench.PKG / "reference"):
        for m in _imported(tree):
            assert m.split(".")[0] != "repro_torch", (path.name, m)


def test_reads_nothing_under_benchmarks():
    for path, tree in _modules(bench.PKG):
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert "benchmarks/" not in node.value, path.name
            if isinstance(node, ast.Name):
                assert node.id != "benchmarks", path.name


def test_run_refuses_a_loaded_jax():
    assert bench.loaded_forbidden(["torch", "repro_torch.api", "reprox",
                                   "jax.numpy"]) == ["jax"]
    assert bench.loaded_forbidden(["repro.core.placement", "flax"]) == \
        ["flax", "repro"]
    assert bench.loaded_forbidden(["torch", "repro_torch"]) == []
