"""What the benchmark may import: no JAX and no JAX package anywhere
under ``bench/``, and nothing of the program in the references.  Module
names are compared by their top-level name, whole: ``repro_torch``
begins with ``repro`` and is not it."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports, at any depth."""
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "repro_torch" not in tops
    assert tops <= {"__future__", "math", "numpy", "torch"}, tops


def test_top_level_names_are_compared_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.api\nfrom repro_torch import kernels"
                     "\nimport jaxtyping\n")
    assert imported_tops(probe) == {"repro_torch", "jaxtyping"}
    assert not imported_tops(probe) & FORBIDDEN


def test_a_cell_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole tiny run on the CPU in a fresh process, then the harness's
    own look at ``sys.modules``."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent / 'src')!r}]\n"
        "import harness\n"
        "from test_bench_harness import tiny_root, BENCHMARK, CELLS\n"
        "from pathlib import Path\n"
        f"root = tiny_root(Path({str(tmp_path)!r}))\n"
        "res = harness.run_cell(CELLS[0], 3, 0.3, False,\n"
        "                       root=root, device='cpu', bench=BENCHMARK)\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
