"""Rating-frame preprocessing.

A copy of anime_recommendations_tpu/data/preprocess.py, so that the port
loads nothing of the JAX package:
  * drop duplicate rows and rows with NA
  * optionally drop rows with 0 episodes watched
  * optionally drop "plan to watch" rows (status 6)
  * drop users with < num_reviews ratings
  * optionally drop rows where the user watched less
    than half of the anime's episodes
  * min-max scale ratings to [0, 1]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pandas as pd


@dataclass(frozen=True)
class PreprocessStats:
    rows_in: int
    rows_out: int
    n_users: int
    n_anime: int
    min_rating: float
    max_rating: float


def drop_useless(
    df: pd.DataFrame,
    num_reviews: int = 400,
    drop_unwatched: bool = False,
    drop_plan: bool = False,
) -> pd.DataFrame:
    """Dedupe/dropna + optional filters + min-ratings-per-user filter."""
    df = df.drop_duplicates()
    df = df.dropna()
    if drop_unwatched and "watched_episodes" in df.columns:
        df = df[df["watched_episodes"] != 0]
    if drop_plan and "watching_status" in df.columns:
        df = df[df["watching_status"] != 6]
    counts = df["user_id"].value_counts(dropna=True)
    keep = counts[counts >= int(num_reviews)].index
    return df[df["user_id"].isin(keep)].copy()


def drop_half_watched(df: pd.DataFrame) -> pd.DataFrame:
    """Keep rows where the user watched >= half of the anime's episodes.

    The per-anime episode total is estimated as the max watched_episodes seen
    for that anime (preprocess.py:62-64); single-episode anime are always
    kept (preprocess.py:80-84).
    """
    max_eps = df.groupby("anime_id")["watched_episodes"].transform("max")
    half_eps = np.where(max_eps == 1, 1.0, max_eps * 0.5)
    out = df.copy()
    out["max_eps"] = max_eps
    out["half_eps"] = half_eps
    return out[out["watched_episodes"] >= out["half_eps"]]


def scale_ratings(df: pd.DataFrame) -> pd.DataFrame:
    """Min-max scale the rating column to [0, 1] as float64."""
    r = df["rating"].to_numpy()
    lo, hi = float(r.min()), float(r.max())
    span = hi - lo
    if span == 0.0:
        scaled = np.zeros_like(r, dtype=np.float64)
    else:
        scaled = ((r - lo) / span).astype(np.float64)
    out = df.copy()
    out["rating"] = scaled
    return out


def preprocess_ratings(
    df: pd.DataFrame,
    num_reviews: int = 400,
    drop_unwatched: bool = False,
    drop_plan: bool = False,
    half_watched: bool = False,
) -> tuple[pd.DataFrame, PreprocessStats]:
    """Full preprocess pass; returns the cleaned frame plus audit stats."""
    rows_in = len(df)
    raw_min = float(df["rating"].min()) if rows_in else 0.0
    raw_max = float(df["rating"].max()) if rows_in else 0.0
    df = drop_useless(
        df,
        num_reviews=num_reviews,
        drop_unwatched=drop_unwatched,
        drop_plan=drop_plan,
    )
    if half_watched:
        df = drop_half_watched(df)
        df = df.drop(columns=["max_eps", "half_eps"])
    df = scale_ratings(df)
    stats = PreprocessStats(
        rows_in=rows_in,
        rows_out=len(df),
        n_users=df["user_id"].nunique(),
        n_anime=df["anime_id"].nunique(),
        min_rating=raw_min,
        max_rating=raw_max,
    )
    return df, stats
