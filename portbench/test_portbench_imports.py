"""The benchmark imports neither JAX nor the JAX package, and its reference
imports nothing of the program: every module's top-level name compared
whole (``repro_torch`` is not ``repro``)."""
import ast
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def _sources():
    return [p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not (_top_names(path) & FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        names = _top_names(path)
        assert "repro_torch" not in names, path
        assert names <= {"__future__", "math", "typing", "torch",
                         "portbench"}, (path, names)


def test_the_run_guard_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(HERE.parent))
    from portbench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_fake.sub", object())
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in harness.forbidden_modules()
