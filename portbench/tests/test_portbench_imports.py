"""What the benchmark may import and read: no JAX and no JAX package
anywhere under ``portbench/``, nothing of the port in the reference, and
none of the old benchmark's files."""

import ast
import sys
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
               p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "distributed_tensorflow_guide_tpu"}


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    tops = imported_tops(path)
    assert "distributed_tensorflow_guide_tpu_torch" not in tops
    assert tops <= {"__future__", "contextlib", "math", "statistics",
                    "torch", "portbench"}


def test_nothing_reads_the_old_benchmark():
    old = ("benchmarks/", "bench.py", "chip_smoke", "chip_e2e_phases",
           "BENCH_r0", "MULTICHIP_r0")
    for path in FILES + [BENCH.parent / "BENCHMARK.json"]:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert not [o for o in old if o in text], path


def test_the_module_check_compares_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "distributed_tensorflow_guide_tpu_torch",
                        object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "distributed_tensorflow_guide_tpu.ops",
                        object())
    assert harness.forbidden_loaded() == ["distributed_tensorflow_guide_tpu",
                                          "jax"]
