"""Synthetic MyAnimeList-shaped data.

A copy of anime_recommendations_tpu/data/synthetic.py, so that the port
loads nothing of the JAX package: ratings, catalog and synopses with the real
schemas and a planted low-rank structure, made from a numpy seed. The same
seed gives the same frames in both packages.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

_GENRE_POOL = [
    "Action", "Adventure", "Comedy", "Drama", "Fantasy", "Horror", "Magic",
    "Mystery", "Romance", "Sci-Fi", "Slice of Life", "Sports", "Super Power",
    "Supernatural", "Thriller", "Military", "Psychological", "Seinen",
    "Shounen", "Vampire", "Martial Arts", "Music", "School", "Space",
]
_SOURCE_POOL = [
    "Manga", "Original", "Light novel", "Visual novel", "Game", "Novel",
    "4-koma manga", "Web manga", "Other",
]
_TYPE_POOL = ["TV", "Movie", "OVA", "Special", "ONA", "Music"]
_RATING_POOL = [
    "G - All Ages", "PG - Children", "PG-13 - Teens 13 or older",
    "R - 17+ (violence & profanity)", "R+ - Mild Nudity",
]
_STUDIO_POOL = [
    "Madhouse", "Bones", "Kyoto Animation", "Sunrise", "A-1 Pictures",
    "Wit Studio", "Production I.G", "Toei Animation", "J.C.Staff", "Shaft",
]


# Raw MAL-style ids are an affine map of the dense factor row (see
# synth_ratings below); the inverses let the convergence harness recover
# the teacher row for any raw id.
USER_ID_STRIDE, USER_ID_BASE = 7, 11
ANIME_ID_STRIDE, ANIME_ID_BASE = 13, 5
TEACHER_GAIN = 3.0  # score = sigmoid(TEACHER_GAIN * affinity + noise)


def planted_factors(
    n_users: int, n_anime: int, latent_dim: int = 16, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.random.Generator]:
    """The low-rank teacher behind synth_ratings: (U, V, continuing rng).

    Factor row i corresponds to raw user_id i*USER_ID_STRIDE+USER_ID_BASE /
    raw anime_id i*ANIME_ID_STRIDE+ANIME_ID_BASE. The returned generator has
    consumed exactly the factor draws, so synth_ratings(seed=s) and
    planted_factors(seed=s) agree bit-for-bit on U and V."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, latent_dim)) / np.sqrt(latent_dim)
    V = rng.normal(size=(n_anime, latent_dim)) / np.sqrt(latent_dim)
    return U, V, rng


def synth_ratings(
    n_users: int = 5000,
    n_anime: int = 1200,
    n_interactions: int = 400_000,
    latent_dim: int = 16,
    seed: int = 0,
    noise: float = 0.35,
) -> pd.DataFrame:
    """user_stats.parquet-shaped frame: user_id, anime_id, rating,
    watching_status, watched_episodes. Ratings 1..10 from planted factors."""
    U, V, rng = planted_factors(n_users, n_anime, latent_dim, seed)

    # Popularity-skewed sampling (Zipf-ish) to mimic hot anime/users.
    user_p = _zipf_probs(n_users, rng)
    anime_p = _zipf_probs(n_anime, rng)
    users = rng.choice(n_users, size=n_interactions, p=user_p)
    anime = rng.choice(n_anime, size=n_interactions, p=anime_p)

    affinity = np.einsum("ij,ij->i", U[users], V[anime])
    score = 1.0 / (1.0 + np.exp(-(affinity * TEACHER_GAIN + rng.normal(0, noise, n_interactions))))
    rating = np.clip(np.round(1 + 9 * score), 1, 10).astype(np.int64)

    episodes_total = rng.integers(1, 60, size=n_anime)
    watched = rng.integers(0, episodes_total[anime] + 1)
    status = rng.choice([1, 2, 3, 4, 6], size=n_interactions, p=[0.15, 0.55, 0.1, 0.1, 0.1])

    df = pd.DataFrame(
        {
            # Raw IDs deliberately non-contiguous, like MAL IDs.
            "user_id": users * USER_ID_STRIDE + USER_ID_BASE,
            "anime_id": anime * ANIME_ID_STRIDE + ANIME_ID_BASE,
            "rating": rating,
            "watching_status": status,
            "watched_episodes": watched,
        }
    )
    # Reference frames arrive sorted by user id (SURVEY §2 #5 note).
    return df.sort_values("user_id", kind="stable").reset_index(drop=True)


def synth_anime_catalog(n_anime: int = 1200, seed: int = 0) -> pd.DataFrame:
    """all_anime.csv-shaped frame keyed by MAL_ID."""
    rng = np.random.default_rng(seed + 1)
    mal_ids = np.arange(n_anime) * 13 + 5
    names = [f"Anime {i:05d}" for i in range(n_anime)]
    # Sprinkle irregular glyphs so name-cleaning paths are exercised.
    for i in range(0, n_anime, 97):
        names[i] = f"Anime☆{i:05d}"
    genres = [
        ", ".join(sorted(rng.choice(_GENRE_POOL, size=rng.integers(1, 5), replace=False)))
        for _ in range(n_anime)
    ]
    episodes = rng.integers(1, 60, size=n_anime).astype(object)
    score = np.round(rng.uniform(4.0, 9.5, size=n_anime), 2).astype(object)
    # "Unknown" entries exercise the Unknown -> NaN path.
    for i in range(0, n_anime, 53):
        episodes[i] = "Unknown"
    for i in range(0, n_anime, 71):
        score[i] = "Unknown"
    return pd.DataFrame(
        {
            "MAL_ID": mal_ids,
            "Name": names,
            "English name": names,
            "Japanese name": [f"アニメ{i:05d}" for i in range(n_anime)],
            "Score": score,
            "Genres": genres,
            "Type": rng.choice(_TYPE_POOL, size=n_anime, p=[0.45, 0.15, 0.15, 0.1, 0.1, 0.05]),
            "Episodes": episodes,
            "Premiered": [
                f"{rng.choice(['Winter', 'Spring', 'Summer', 'Fall'])} {rng.integers(1990, 2023)}"
                for _ in range(n_anime)
            ],
            "Studios": rng.choice(_STUDIO_POOL, size=n_anime),
            "Source": rng.choice(_SOURCE_POOL, size=n_anime),
            "Rating": rng.choice(_RATING_POOL, size=n_anime),
            "Members": rng.integers(1000, 2_000_000, size=n_anime),
        }
    )


def synth_synopses(anime_catalog: pd.DataFrame, seed: int = 0) -> pd.DataFrame:
    """synopses.csv-shaped frame; ~10% of anime have no synopsis row."""
    rng = np.random.default_rng(seed + 2)
    keep = rng.random(len(anime_catalog)) > 0.1
    sub = anime_catalog[keep]
    return pd.DataFrame(
        {
            "MAL_ID": sub["MAL_ID"].to_numpy(),
            "Name": sub["Name"].to_numpy(),
            "Genres": sub["Genres"].to_numpy(),
            "sypnopsis": [
                f"Synopsis of {name}: a tale of {g.split(',')[0].lower()}."
                for name, g in zip(sub["Name"], sub["Genres"])
            ],
        }
    )


def _zipf_probs(n: int, rng: np.random.Generator, alpha: float = 0.8) -> np.ndarray:
    ranks = rng.permutation(n) + 1
    p = 1.0 / ranks**alpha
    return p / p.sum()
