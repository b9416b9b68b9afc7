"""Raw-data acquisition.

Counterpart of anime_recommendations_tpu/data/ingest.py: local files take
priority (parquet through pandas; CSV through the native numeric parser,
data/fastcsv.py, which hands files with string columns to pandas), and when
they are missing a schema-identical synthetic dataset is generated from the
config's seed. Downloading is not ported: a config that allows it for a
missing file raises.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path

import pandas as pd

from anime_recommendations_tpu_torch.config import DataConfig
from anime_recommendations_tpu_torch.data import synthetic

logger = logging.getLogger(__name__)


@dataclass
class RawData:
    ratings: pd.DataFrame
    anime: pd.DataFrame
    synopses: pd.DataFrame
    source: str  # "local" | "synthetic"


def _read_any(path: Path) -> pd.DataFrame:
    if path.suffix == ".parquet":
        return pd.read_parquet(path)
    if path.suffix == ".csv":
        from anime_recommendations_tpu_torch.data.fastcsv import read_numeric_csv

        return read_numeric_csv(path)
    return pd.read_csv(path)


def load_raw(cfg: DataConfig, cache_dir: str | Path = "data") -> RawData:
    """Resolve the three raw inputs: local files, else synthetic.
    ``cache_dir`` is where the JAX package downloads a missing file to."""
    paths = {
        "ratings": (Path(cfg.stats_path), cfg.stats_url),
        "anime": (Path(cfg.anime_path), cfg.anime_url),
        "synopses": (Path(cfg.synopses_path), cfg.synopses_url),
    }
    frames: dict[str, pd.DataFrame] = {}
    for key, (path, url) in paths.items():
        if path.exists():
            frames[key] = _read_any(path)
        elif cfg.allow_download and url:
            raise NotImplementedError(
                f"{path} is missing and downloading ({url} into {Path(cache_dir)}) is not "
                "ported: place the file locally (ROADMAP.md Queue 1)")
        else:
            break
    if len(frames) == 3:
        return RawData(ratings=frames["ratings"], anime=frames["anime"],
                       synopses=frames["synopses"], source="local")
    logger.warning(
        "raw data not found (%s) - generating synthetic dataset "
        "(users=%d anime=%d interactions=%d)",
        [str(p) for p, _ in paths.values()],
        cfg.synthetic_users, cfg.synthetic_anime, cfg.synthetic_interactions,
    )
    anime = synthetic.synth_anime_catalog(n_anime=cfg.synthetic_anime,
                                          seed=cfg.synthetic_seed)
    return RawData(
        ratings=synthetic.synth_ratings(
            n_users=cfg.synthetic_users, n_anime=cfg.synthetic_anime,
            n_interactions=cfg.synthetic_interactions, seed=cfg.synthetic_seed),
        anime=anime,
        synopses=synthetic.synth_synopses(anime, seed=cfg.synthetic_seed),
        source="synthetic",
    )
