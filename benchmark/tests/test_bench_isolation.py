"""What the benchmark may import and load, and its exits without a card.

No module the benchmark runs has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``nufhe_tpu`` (the JAX package), compared whole, so
``nufhe_tpu_torch`` passes; the reference imports nothing of the program.
"""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "nufhe_tpu"}


def _imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[p.relative_to(BENCH).as_posix()
                              for p in SOURCES])
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imported_tops(path) & FORBIDDEN


def test_the_comparison_is_by_whole_top_level_names():
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    saved = dict(sys.modules)
    try:
        sys.modules["nufhe_tpu_torch_like"] = object()
        assert "nufhe_tpu_torch" not in run.forbidden_modules()
        sys.modules["nufhe_tpu.ops"] = object()
        assert run.forbidden_modules() == ["nufhe_tpu.ops"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


@pytest.mark.parametrize("path",
                         sorted((BENCH / "reference").rglob("*.py")))
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imported_tops(path) <= {"torch", "math"}


def test_a_cpu_run_loads_no_jax(tmp_path):
    """A whole small run on the CPU, then the modules it loaded."""
    code = (
        "import sys, time, json\n"
        "sys.path.insert(0, %r)\n"
        "from benchmark.tests.conftest import small_cell\n"
        "from benchmark.lib import runner\n"
        "cell = small_cell('fft.nand_b16384', batch=16, rows=4)\n"
        "res = runner.run_cell(cell, 5, 0.1, False, 'cpu',"
        " time.perf_counter(), log=lambda *a: None)\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([res['correct'], tops]))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct
    assert "nufhe_tpu_torch" in tops and not set(tops) & FORBIDDEN


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "fft.nand_b16384",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"]
        + list(extra), capture_output=True, text=True, timeout=600, cwd=cwd)


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_a_cell_runs_on_the_card(cuda_card, tmp_path):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ntt.add16_x4",
         "--seed", "3", "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
    assert list(result)[-1] == "checks"
