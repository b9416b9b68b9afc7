"""Raw-data acquisition.

Counterpart of anime_recommendations_tpu/data/ingest.py: local files take
priority (parquet through pandas; CSV through the native numeric parser,
data/fastcsv.py, which hands files with string columns to pandas); a
missing file is downloaded into the cache directory when the config allows
it and names a URL; and when a file is neither local nor downloadable, a
schema-identical synthetic dataset is generated from the config's seed.
The download goes through the standard library's urllib, where JAX uses
requests: an HTTP error status raises urllib.error.HTTPError (ROADMAP.md
Queue 3), and nothing falls back to synthetic data after a failed download.
"""

from __future__ import annotations

import logging
import urllib.request
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
    source: str  # "local" | "download" | "synthetic"


def _read_any(path: Path) -> pd.DataFrame:
    if path.suffix == ".parquet":
        return pd.read_parquet(path)
    if path.suffix == ".csv":
        from anime_recommendations_tpu_torch.data.fastcsv import read_numeric_csv

        return read_numeric_csv(path)
    return pd.read_csv(path)


def _download(url: str, dest: Path) -> Path:
    """Stream ``url`` into ``dest`` in 1 MiB chunks, with a 60 s timeout; an
    HTTP error status raises before ``dest`` is opened."""
    dest.parent.mkdir(parents=True, exist_ok=True)
    with urllib.request.urlopen(url, timeout=60) as resp, open(dest, "wb") as f:
        while chunk := resp.read(1 << 20):
            f.write(chunk)
    return dest


def load_raw(cfg: DataConfig, cache_dir: str | Path = "data") -> RawData:
    """Resolve the three raw inputs: local file > gated download into
    ``cache_dir`` > synthetic. ``source`` is "download" once any file was
    downloaded."""
    cache = Path(cache_dir)
    paths = {
        "ratings": (Path(cfg.stats_path), cfg.stats_url),
        "anime": (Path(cfg.anime_path), cfg.anime_url),
        "synopses": (Path(cfg.synopses_path), cfg.synopses_url),
    }
    frames: dict[str, pd.DataFrame] = {}
    source = "local"
    for key, (path, url) in paths.items():
        if path.exists():
            frames[key] = _read_any(path)
        elif cfg.allow_download and url:
            dest = cache / path.name
            logger.info("downloading %s -> %s", url, dest)
            frames[key] = _read_any(_download(url, dest))
            source = "download"
        else:
            break
    if len(frames) == 3:
        return RawData(ratings=frames["ratings"], anime=frames["anime"],
                       synopses=frames["synopses"], source=source)
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
