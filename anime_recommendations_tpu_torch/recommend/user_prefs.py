"""User preference profiling (favorite genres and source material).

Host-only counterpart of anime_recommendations_tpu/recommend/user_prefs.py,
copied:
  * favorites = the user's ratings at or above their own
    ``favorite_percentile`` percentile
  * favorite rows are returned in CATALOG order, carrying eng_version +
    Genres/Source
  * the merged preferences frame has columns eng_version, Source, Genres
  * genre/source frequency dicts feed the word clouds
"""

from __future__ import annotations

from dataclasses import dataclass

import pandas as pd

from anime_recommendations_tpu_torch.recommend.context import RecContext


@dataclass
class UserPrefs:
    user_id: int
    genres: pd.DataFrame       # eng_version, Genres (catalog order)
    sources: pd.DataFrame      # eng_version, Source
    merged: pd.DataFrame       # eng_version, Source, Genres
    genre_frequencies: dict[str, int]
    source_frequencies: dict[str, int]


def fave_rows(ctx: RecContext, user_id: int, percentile: float) -> pd.DataFrame:
    """Catalog rows of the user's >= percentile-rated anime, in catalog
    (Score-sorted) order, not rating order."""
    pos = ctx.favorite_positions(user_id, percentile)
    return ctx.catalog.anime.iloc[pos]


def fave_genres(ctx: RecContext, user_id: int, percentile: float = 80.0) -> pd.DataFrame:
    return pd.DataFrame(fave_rows(ctx, user_id, percentile)[["eng_version", "Genres"]])


def fave_sources(ctx: RecContext, user_id: int, percentile: float = 80.0) -> pd.DataFrame:
    return pd.DataFrame(fave_rows(ctx, user_id, percentile)[["eng_version", "Source"]])


def get_fave_df(genres: pd.DataFrame, sources: pd.DataFrame) -> pd.DataFrame:
    """Merged favorites: eng_version, Source, Genres."""
    merged = sources.copy()
    merged["Genres"] = genres["Genres"]
    return merged


def frequency_dict(col: pd.Series) -> dict[str, int]:
    """Comma-split token counts."""
    out: dict[str, int] = {}
    for entry in col:
        if isinstance(entry, str):
            for token in entry.split(","):
                token = token.strip()
                out[token] = out.get(token, 0) + 1
    return out


def user_prefs(
    ctx: RecContext, user_id: int, percentile: float = 80.0
) -> UserPrefs:
    rows = fave_rows(ctx, user_id, percentile)
    genres = pd.DataFrame(rows[["eng_version", "Genres"]])
    sources = pd.DataFrame(rows[["eng_version", "Source"]])
    merged = get_fave_df(genres, sources)
    return UserPrefs(
        user_id=user_id,
        genres=genres,
        sources=sources,
        merged=merged,
        genre_frequencies=frequency_dict(genres["Genres"]),
        source_frequencies=frequency_dict(sources["Source"]),
    )
