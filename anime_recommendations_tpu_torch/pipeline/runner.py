"""Serving part of the pipeline runner: a RecContext from a trained run.

Counterpart of PipelineRunner.context() in
anime_recommendations_tpu/pipeline/runner.py. It reads the artifacts the
JAX pipeline wrote (anime_nn_model.npz with vocab.json,
preprocessed_stats.parquet, all_anime.csv, synopses.csv) and builds the
port's context on ``device``. The other pipeline steps (ingest, preprocess,
train, the per-step CSV artifacts) are not ported yet (ROADMAP.md).

The store's layout is anime_recommendations_tpu/pipeline/artifacts.py's:
``<root>/<name>/v<N>/{files..., .metadata.json}``, with ``name`` made
filesystem-safe by replacing every run of characters outside
[A-Za-z0-9._-] with "_". That module is not imported here because its
package imports jax.
"""

from __future__ import annotations

import re
from pathlib import Path

import pandas as pd

from anime_recommendations_tpu_torch.config import Config
from anime_recommendations_tpu_torch.data.catalog import Catalog
from anime_recommendations_tpu_torch.data.vocab import Vocab, encode_frame
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.train.model_io import load_model

_SAFE = re.compile(r"[^A-Za-z0-9._-]+")


def latest_file(root: str | Path, name: str, filename: str | None = None) -> Path:
    """Path of ``filename`` (default: the artifact's only file) in the
    newest version of artifact ``name``."""
    art_dir = Path(root) / _SAFE.sub("_", name)
    versions = [
        int(p.name[1:]) for p in art_dir.glob("v*")
        if p.is_dir() and p.name[1:].isdigit()
    ] if art_dir.is_dir() else []
    if not versions:
        raise FileNotFoundError(f"No artifact named {name!r} in {root}")
    vdir = art_dir / f"v{max(versions)}"
    if filename is None:
        files = sorted(p for p in vdir.iterdir() if p.name != ".metadata.json")
        if len(files) != 1:
            raise ValueError(f"{name} holds {len(files)} files; name one of "
                             f"{[f.name for f in files]}")
        return files[0]
    path = vdir / filename
    if not path.exists():
        raise FileNotFoundError(f"{name}:v{max(versions)} has no file {filename!r}")
    return path


def store_root(cfg: Config, run_dir: str | Path | None = None) -> Path:
    """The artifact store of a run, where PipelineRunner puts it."""
    return Path(run_dir or cfg.main.run_dir) / cfg.main.project_name / "artifacts"


def context_from_store(cfg: Config, run_dir: str | Path | None = None, *,
                       device) -> RecContext:
    root = store_root(cfg, run_dir)
    model = load_model(latest_file(root, "anime_nn_model.npz", "anime_nn_model.npz"),
                       device)
    vocab = Vocab.load(latest_file(root, "anime_nn_model.npz", "vocab.json"))
    clean = pd.read_parquet(latest_file(root, "preprocessed_stats.parquet"))
    catalog = Catalog.from_files(latest_file(root, "all_anime.csv"),
                                 latest_file(root, "synopses.csv"))
    return RecContext.build(
        model, vocab, catalog, encode_frame(clean, vocab), device=device,
        retrieval_dtype=cfg.similarity.retrieval_dtype, ann=cfg.similarity.ann,
    )
