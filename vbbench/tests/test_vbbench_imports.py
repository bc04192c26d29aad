"""Nothing the benchmark runs imports JAX or the JAX package `repro`, and
the plain reference imports nothing of the program `repro_torch`:
checked by each import's top-level name, compared whole (the port's
name begins with the JAX package's)."""
from __future__ import annotations

import ast
from pathlib import Path

VBBENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_top_level_name_is_compared_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.core\nfrom repro_torch import x\n"
                     "import jax.numpy\n")
    assert top_level_imports(probe) == {"repro_torch", "jax"}
    assert top_level_imports(probe) & NEVER == {"jax"}


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p in VBBENCH.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    for p in files:
        assert not top_level_imports(p) & NEVER, p


def test_reference_imports_nothing_of_the_program():
    files = list((VBBENCH / "reference").rglob("*.py"))
    assert files
    for p in files:
        names = top_level_imports(p)
        assert not names & (NEVER | {"repro_torch", "vbbench"}), (p, names)


def test_run_reports_a_loaded_jax_package(monkeypatch):
    import sys
    import types
    from vbbench import harness
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["repro"]
    monkeypatch.delitem(sys.modules, "repro.core")
    monkeypatch.setitem(sys.modules, "repro_torch_extra",
                        types.ModuleType("y"))
    assert "repro" not in harness.forbidden_modules()
