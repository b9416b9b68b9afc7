"""User-based recommendations (favorites of similar users).

Host-only counterpart of anime_recommendations_tpu/recommend/user_recs.py,
copied: for each similar user take their percentile-favorites, drop anime
already among the query user's favorites (by eng_version), then rank the
candidates by how many similar users favorited them. Enrichment is by
cleaned-name lookup, first catalog hit wins.

Output schema: anime_id, Name, n_user_prefs, Source, Genres, Sypnopsis,
Episodes, Japanese name, Studios, Premiered, Score, Type.
"""

from __future__ import annotations

import re

import numpy as np
import pandas as pd

from anime_recommendations_tpu_torch.utils.text import clean_names
from anime_recommendations_tpu_torch.recommend.context import RecContext

OUTPUT_COLUMNS = [
    "anime_id", "Name", "n_user_prefs", "Source", "Genres", "Sypnopsis",
    "Episodes", "Japanese name", "Studios", "Premiered", "Score", "Type",
]


def user_recs(
    ctx: RecContext,
    user_id: int,
    similar_user_ids: np.ndarray,
    n: int = 10,
    percentile: float = 80.0,
    genres: list | None = None,
    user_pref: pd.DataFrame | None = None,
) -> tuple[pd.DataFrame, str]:
    """Rank anime by the number of similar users who favorited them.

    ``user_pref``: the query user's favorites frame (must contain
    eng_version); recomputed at ``percentile`` when None.
    ``genres``: optional 3-genre restriction.
    Returns (frame, csv_filename).
    """
    filename = f"User_ID_{user_id}_user_recs.csv"
    eng = ctx.catalog.eng_values
    if user_pref is None:
        seen_eng = set(eng[ctx.favorite_positions(user_id, percentile)])
    else:
        seen_eng = set(user_pref["eng_version"].tolist())

    collected: list[str] = []
    for sim_id in similar_user_ids:
        pos = ctx.favorite_positions(int(sim_id), percentile)
        collected.extend(v for v in eng[pos] if v not in seen_eng)

    if not collected:
        return pd.DataFrame(columns=OUTPUT_COLUMNS), filename

    counts = pd.Series(collected).value_counts()

    # First catalog row per cleaned name.
    first_pos = ctx.catalog.eng_first_pos
    pairs = [(n_, first_pos[n_]) for n_ in counts.index if n_ in first_pos]
    pos = np.asarray([p for _, p in pairs], np.int64)
    cols = ctx.catalog.column_arrays
    aid = cols["anime_id"][pos]
    frame = pd.DataFrame(
        {
            "anime_id": aid,
            "Name": cols["Name"][pos],
            "n_user_prefs": counts.loc[[n_ for n_, _ in pairs]].to_numpy(),
            "Source": cols["Source"][pos],
            "Genres": cols["Genres"][pos],
            "Sypnopsis": [ctx.catalog.synopsis_of(int(a)) for a in aid],
            "Episodes": cols["Episodes"][pos],
            "Japanese name": cols["japanese_name"][pos],
            "Studios": cols["Studios"][pos],
            "Premiered": cols["Premiered"][pos],
            "Score": cols["Score"][pos],
            "Type": cols["Type"][pos],
        }
    )
    if genres is not None:
        mask = _genre_row_mask(frame["Genres"], genres)
        frame = frame[mask]
    return frame.head(n).reset_index(drop=True), filename


def _genre_row_mask(genre_col: pd.Series, genres: list) -> np.ndarray:
    """Substring match of cleaned genres against lowercased space-stripped
    Genres strings; 'none' never matches."""
    use = [g for g in clean_names([str(g) for g in genres]) if g != "none"]
    keys = genre_col.astype(str).str.lower().str.replace(" ", "", regex=False)
    mask = np.zeros(len(genre_col), dtype=bool)
    for g in use:
        mask |= keys.str.contains(re.escape(g), regex=True).to_numpy()
    return mask
