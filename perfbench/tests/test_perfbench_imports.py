"""The import guard: nothing under perfbench/ imports JAX or the JAX
package (top-level names compared whole: ``repro_torch`` begins with
``repro``), and the plain references import nothing of the program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FILES = sorted((REPO / "perfbench").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(REPO)) for p in FILES])
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((REPO / "perfbench/reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | {"repro_torch", "perfbench"}), names
    assert names <= {"__future__", "math", "torch"}, names


def test_the_guard_sees_through_the_prefix(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.models\nfrom repro.kernels import ops\nimport jaxlib\n")
    assert top_level_imports(probe) & FORBIDDEN == {"repro", "jaxlib"}
