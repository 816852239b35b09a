"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the program; a run without a card, or without
the program beside the benchmark, fails and prints no result."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark.core.harness import FORBIDDEN
from benchmark.core.spec import BENCH_DIR, ROOT


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".", 1)[0] not in FORBIDDEN, (path, name)


def test_references_import_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".", 1)[0] in ("torch", "random", "typing",
                                             "__future__"), (path, name)


def test_a_run_loads_no_forbidden_module():
    """Every cell at its small size in a fresh interpreter, then the
    harness's own look at sys.modules, by whole top-level names."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests.small import SMALL, run_small\n"
        "from benchmark.core.harness import forbidden_modules\n"
        "for name in SMALL:\n"
        "    assert run_small(name, trace=True)['correct'], name\n"
        "found = forbidden_modules()\n"
        "assert not found, found\n"
        "assert 'sppark_tpu_torch' in sys.modules\n"
        "print('clean')\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-3000:]


def test_the_top_level_name_is_compared_whole(monkeypatch):
    from benchmark.core import harness
    monkeypatch.setitem(sys.modules, "sppark_tpu_torch_x", sys)
    assert "sppark_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()


def _run(cwd: Path):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "goldilocks.ntt",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        return                              # the card's own runs say more
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
