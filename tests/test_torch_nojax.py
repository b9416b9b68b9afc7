"""The port runs without jax: importing its serving and training paths loads
no jax module and nothing of the JAX package, and it builds nothing from the
JAX side's files (native/, anime_recommendations_tpu/).

Checked in a subprocess, because this test process has jax loaded
(tests/conftest.py).
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

MODULES = [
    "anime_recommendations_tpu_torch.serve.api",
    "anime_recommendations_tpu_torch.cli",
    "anime_recommendations_tpu_torch.bench",
    "anime_recommendations_tpu_torch.pipeline.runner",
    "anime_recommendations_tpu_torch.recommend.batch",
    "anime_recommendations_tpu_torch.recommend.similar_anime",
    "anime_recommendations_tpu_torch.recommend.similar_users",
    "anime_recommendations_tpu_torch.recommend.model_recs",
    "anime_recommendations_tpu_torch.recommend.user_prefs",
    "anime_recommendations_tpu_torch.recommend.user_recs",
    "anime_recommendations_tpu_torch.recommend.clouds",
    "anime_recommendations_tpu_torch.ops.normalize",
    "anime_recommendations_tpu_torch.ops.quantized",
    "anime_recommendations_tpu_torch.ops.ivf",
    "anime_recommendations_tpu_torch.utils.profiling",
    "anime_recommendations_tpu_torch.train.trainer",
    "anime_recommendations_tpu_torch.train.fused",
    "anime_recommendations_tpu_torch.train.device_loop",
    "anime_recommendations_tpu_torch.train.checkpoint",
    "anime_recommendations_tpu_torch.train.lazy",
    "anime_recommendations_tpu_torch.train.convergence",
    "anime_recommendations_tpu_torch.data.ingest",
    "anime_recommendations_tpu_torch.data.fastcsv",
    "anime_recommendations_tpu_torch.parallel",
    "anime_recommendations_tpu_torch.parallel.mesh",
    "anime_recommendations_tpu_torch.parallel.routing",
    "anime_recommendations_tpu_torch.parallel.sharded_train",
    "anime_recommendations_tpu_torch.parallel.trainer",
    "anime_recommendations_tpu_torch.parallel.distributed",
]


def imported_after(code: str) -> set[str]:
    """Top-level module names loaded by ``code`` in a fresh interpreter."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    return {name.split(".")[0] for name in out.split()}


def test_serving_path_imports_no_jax():
    loaded = imported_after("\n".join(f"import {m}" for m in MODULES))
    assert "anime_recommendations_tpu_torch" in loaded
    assert not {"jax", "jaxlib", "anime_recommendations_tpu"} & loaded


def imported_names(path: Path) -> set[str]:
    """Top-level names of every import statement in ``path``, function bodies included."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", ["chip_smoke.py", "anime_recommendations_tpu_torch"])
def test_no_import_statement_names_jax_or_the_jax_package(path):
    root = REPO / path
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    assert files
    for f in files:
        assert not {"jax", "jaxlib", "anime_recommendations_tpu"} & imported_names(f), f


@pytest.mark.parametrize("path", ["chip_smoke.py", "anime_recommendations_tpu_torch"])
def test_no_import_statement_names_requests(path):
    """The download goes through urllib: the card's machine is not known to
    have requests."""
    root = REPO / path
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    assert all("requests" not in imported_names(f) for f in files)


@pytest.mark.parametrize("module", ["anime_recommendations_tpu_torch.recommend.tables",
                                    "anime_recommendations_tpu_torch.train.model_io"])
def test_device_half_imports_neither_jax_nor_pandas(module):
    loaded = imported_after(f"import {module}")
    assert "torch" in loaded
    assert not {"jax", "jaxlib", "pandas", "anime_recommendations_tpu"} & loaded


# A reference to a kernel of the JAX package, as chip_smoke.py's kernels
# line gives it ("replaces"): a file and a line, never opened.
_REFERENCE = re.compile(r"anime_recommendations_tpu/[\w/]+\.py:\d+")
_JAX_SIDE = ("native", "anime_recommendations_tpu")


def _docstrings(tree) -> set[int]:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                out.add(id(first.value))
    return out


def jax_side_paths(path: Path) -> list[str]:
    """What in ``path`` names a file of the JAX side to build from or read:
    a string (docstrings aside) that starts with native/ or
    anime_recommendations_tpu/ and is not a file:line reference, and a path
    joined with ``/ "native"`` (but build/native, the port's output
    directory) or ``/ "anime_recommendations_tpu"``."""
    tree = ast.parse(path.read_text())
    docs = _docstrings(tree)
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs
                and node.value.startswith(tuple(f"{p}/" for p in _JAX_SIDE))
                and not _REFERENCE.fullmatch(node.value)):
            found.append(f"{path.name}:{node.lineno} {node.value!r}")
        if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div)
                and isinstance(node.right, ast.Constant) and node.right.value in _JAX_SIDE):
            left = node.left
            in_build = (isinstance(left, ast.BinOp) and isinstance(left.right, ast.Constant)
                        and left.right.value == "build")
            if not (node.right.value == "native" and in_build):
                found.append(f"{path.name}:{node.lineno} / {node.right.value!r}")
    return found


@pytest.mark.parametrize("path", ["chip_smoke.py", "anime_recommendations_tpu_torch"])
def test_nothing_builds_from_native_or_the_jax_package(path):
    """The port builds every source from its own package: no Python module
    of it, and not chip_smoke.py, names a file under native/ or
    anime_recommendations_tpu/ to build or read, and no C++ or CUDA source
    of it includes one."""
    root = REPO / path
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    assert files
    assert [hit for f in files for hit in jax_side_paths(f)] == []
    if root.is_dir():
        sources = [f for f in root.rglob("*") if f.suffix in (".cu", ".cuh", ".cpp", ".h")]
        assert sources
        for f in sources:
            includes = [ln for ln in f.read_text().splitlines() if ln.startswith("#include")]
            assert not [ln for ln in includes if any(p in ln for p in _JAX_SIDE[1:])
                        or "native/" in ln], f


def test_the_builders_read_the_ports_sources():
    """The CSV parser and the CUDA kernels are built from files inside the
    port's package."""
    from anime_recommendations_tpu_torch.data import fastcsv
    from anime_recommendations_tpu_torch.ops import _kernels

    package = REPO / "anime_recommendations_tpu_torch"
    assert fastcsv.SOURCE.is_file() and fastcsv.SOURCE.is_relative_to(package)
    assert _kernels.CSRC.is_relative_to(package)
    assert all((_kernels.CSRC / f"{name}.cu").is_file() for name in _kernels.SOURCES)


def test_the_scan_flags_a_path_under_native(tmp_path):
    """jax_side_paths finds what the test above forbids."""
    bad = tmp_path / "bad.py"
    bad.write_text('from pathlib import Path\nROOT = Path(".")\n'
                   'SRC = ROOT / "native" / "fastcsv.cpp"\n'
                   'OTHER = "anime_recommendations_tpu/data/fastcsv.py"\n'
                   'OK = ROOT / "build" / "native"\n'
                   'REF = "anime_recommendations_tpu/ops/topk.py:84"\n')
    assert sorted(hit.split()[0] for hit in jax_side_paths(bad)) == ["bad.py:3", "bad.py:4"]
