"""The port runs without jax: importing its serving and training paths loads
no jax module and nothing of the JAX package.

Checked in a subprocess, because this test process has jax loaded
(tests/conftest.py).
"""

import ast
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
