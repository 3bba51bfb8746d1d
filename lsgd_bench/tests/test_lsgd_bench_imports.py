"""No file of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the
reference imports nothing of the program; a run in which anything loads
one, a per-layer metric's reader included, gives no result."""
import ast
import importlib
import sys
import time

import pytest

from conftest import CELLS, ROOT, small_files
from lsgd_bench import run as R

BENCH = ROOT / "lsgd_bench"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & {"repro_torch", "lsgd_bench"}
    assert names <= {"__future__", "importlib", "math", "torch"}


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert R.forbidden_modules() == ["repro"]


def test_a_reader_that_loads_jax_gives_no_result(monkeypatch, tmp_path):
    """The look runs after the readers, the reference and the comparison:
    a reader that imports a (stub) ``jax`` fails the traced run."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("STUB = True\n")
    (tmp_path / "loads_jax.py").write_text(
        "def read(win):\n    import jax\n    return 1.0\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    real = R.metric_reader
    monkeypatch.setattr(R, "metric_reader", lambda name: (
        importlib.import_module("loads_jax") if name == "mfu" else real(name)))
    try:
        with pytest.raises(R.Failure, match=r"\['jax'\]"):
            R.run(small_files(CELLS[0]), CELLS[0], 2 ** 31 + 3, 0.2, True,
                  device="cpu", t_start=time.perf_counter(),
                  out_dir=tmp_path / "out")
    finally:
        sys.modules.pop("jax", None)
        sys.modules.pop("loads_jax", None)
