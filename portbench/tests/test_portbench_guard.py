"""The import guard, the reference's independence from the port, and a
measurement path that finds no card."""

import ast
import subprocess
import sys

import pytest
import torch

from portbench import harness

YARDSTICK = ("reference.py", "compare.py", "datagen.py", "work.py", "peaks.py", "trace.py",
             "client.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_forbidden_names_compared_whole():
    assert harness.forbidden_modules(["anime_recommendations_tpu_torch.ops", "numpy"]) == []
    assert harness.forbidden_modules(["anime_recommendations_tpu.ops.topk"]) == [
        "anime_recommendations_tpu"]
    assert harness.forbidden_modules(["jax._src.api", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]
    assert harness.forbidden_modules(["jaxtyping"]) == []


def test_no_module_imports_jax_or_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        tops = {name.partition(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_port(name):
    tops = {n.partition(".")[0] for n in _imports(harness.BENCH / name)}
    assert harness.PORT not in tops, name


def test_a_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload",
                           "anime7m-train-adam", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120, cwd=harness.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    with pytest.raises(harness.NoCard):
        harness.require_cards(1)


def test_a_run_that_loads_jax_prints_no_result(tmp_path):
    """A module of the JAX package's name in sys.modules stops the run."""
    fake = tmp_path / "anime_recommendations_tpu"
    fake.mkdir()
    (fake / "__init__.py").write_text("")
    code = (f"import sys; sys.path.insert(0, {str(tmp_path)!r}); import anime_recommendations_tpu; "
            f"sys.argv = ['run.py', '--workload', 'anime7m-train-adam', '--seed', '1', "
            f"'--seconds', '1', '--trace', '0']; sys.path.insert(0, {str(harness.ROOT)!r}); "
            f"from portbench import run; sys.exit(run.main())")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=harness.ROOT)
    assert proc.returncode == 4 and proc.stdout == ""
    assert "anime_recommendations_tpu" in proc.stderr


def test_a_run_without_the_program_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "anime7m-train-adam",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
