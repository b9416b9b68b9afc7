"""MyAnimeList-shaped inputs made from a run's seed.

The pattern of the port's data/synthetic.py (ratings 1-10 from planted
low-rank factors, Zipf-skewed anime popularity, the catalog's schema),
rewritten to the benchmark's rules and drawn on the device in a few large
calls:

* no (user, anime) pair repeats: each user's anime are a weighted sample
  without replacement (Efraimidis-Spirakis keys log(u) / popularity, the
  user's count largest kept);
* per-user counts are log-normal with the configuration's mean, capped at
  the anime count, and sum to the configuration's rating count exactly;
* rows are ordered by user, as the source file is.

The same seed gives the same inputs on every device of one kind. Both the
program and the reference are handed these inputs; neither makes its own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import pandas as pd
import torch

LATENT = 16                 # rank of the planted factors
TEACHER_GAIN = 3.0          # score = sigmoid(gain * affinity + noise)
NOISE = 0.35
ZIPF = 0.8                  # anime popularity exponent
KEY_ELEMENTS = 1 << 26      # sampling keys per chunk of users
USER_ID_STRIDE, USER_ID_BASE = 7, 11      # raw ids, non-contiguous like MAL's
ANIME_ID_STRIDE, ANIME_ID_BASE = 13, 5
GENRES = [
    "Action", "Adventure", "Comedy", "Drama", "Fantasy", "Horror", "Magic",
    "Mystery", "Romance", "Sci-Fi", "Slice of Life", "Sports", "Super Power",
    "Supernatural", "Thriller", "Military", "Psychological", "Seinen",
    "Shounen", "Vampire", "Martial Arts", "Music", "School", "Space",
]
TYPES = ["TV", "Movie", "OVA", "Special", "ONA", "Music"]
TYPE_P = [0.45, 0.15, 0.15, 0.1, 0.1, 0.05]
SOURCES = ["Manga", "Original", "Light novel", "Visual novel", "Game", "Novel", "Other"]
STUDIOS = ["Madhouse", "Bones", "Kyoto Animation", "Sunrise", "A-1 Pictures",
           "Wit Studio", "Production I.G", "Toei Animation", "J.C.Staff", "Shaft"]
RATINGS = ["G - All Ages", "PG - Children", "PG-13 - Teens 13 or older",
           "R - 17+ (violence & profanity)", "R+ - Mild Nudity"]


def sub_seeds(seed: int, n: int = 8) -> list[int]:
    """``n`` independent 63-bit seeds from a run's seed (any whole number)."""
    state = np.random.SeedSequence(int(seed) % 2**64).generate_state(n, np.uint64)
    return [int(s) >> 1 for s in state]


def user_counts(n_users: int, n_anime: int, n_ratings: int, sigma: float,
                rng: np.random.Generator) -> np.ndarray:
    """Per-user rating counts: log-normal draws scaled to sum to
    ``n_ratings``, each in [1, n_anime]. What the rounding, the floor and
    the cap leave over is spread one rating at a time over the users with
    the largest (or, to take away, the smallest) remainders."""
    if not n_users <= n_ratings <= n_users * n_anime:
        raise ValueError(f"{n_ratings} ratings do not fit {n_users} users x {n_anime} anime")
    x = rng.lognormal(0.0, sigma, n_users)
    want = x * (n_ratings / x.sum())
    counts = np.clip(np.floor(want), 1, n_anime).astype(np.int64)
    while (rest := n_ratings - int(counts.sum())) != 0:
        room = np.flatnonzero(counts < n_anime if rest > 0 else counts > 1)
        frac = want[room] - counts[room]
        pick = room[np.argsort(-frac if rest > 0 else frac, kind="stable")[:abs(rest)]]
        counts[pick] += 1 if rest > 0 else -1
    return counts


class Ratings(NamedTuple):
    users: torch.Tensor       # [n] int64 user rows, ordered by user
    anime: torch.Tensor       # [n] int64 anime rows
    rating: torch.Tensor      # [n] f32, min-max scaled to [0, 1]
    raw: torch.Tensor         # [n] int8, 1..10
    counts: np.ndarray        # [n_users] rows per user
    offsets: np.ndarray       # [n_users + 1] start of each user's rows


@torch.no_grad()
def ratings(cfg: dict, seed: int, device) -> Ratings:
    """The configuration's ratings, drawn on ``device`` from ``seed``."""
    n_users, n_anime, n = cfg["n_users"], cfg["n_anime"], cfg["n_ratings"]
    s = sub_seeds(seed)
    rng = np.random.default_rng(s[0])
    counts = user_counts(n_users, n_anime, n, cfg["assumed"]["count_sigma"], rng)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    ranks = torch.from_numpy(rng.permutation(n_anime) + 1.0)
    popularity = (1.0 / ranks ** ZIPF).float().to(device)
    g = torch.Generator(device=device).manual_seed(s[1])
    u_lat = torch.randn(n_users, LATENT, generator=g, device=device) / LATENT ** 0.5
    a_lat = torch.randn(n_anime, LATENT, generator=g, device=device) / LATENT ** 0.5
    anime = torch.empty(n, dtype=torch.int64, device=device)
    chunk = max(1, KEY_ELEMENTS // n_anime)
    col = torch.arange(n_anime, device=device)
    for lo in range(0, n_users, chunk):
        hi = min(lo + chunk, n_users)
        keys = torch.rand(hi - lo, n_anime, generator=g, device=device).log_() / popularity
        kmax = int(counts[lo:hi].max())
        top = torch.topk(keys, kmax, dim=1, sorted=True).indices
        keep = col[:kmax] < torch.from_numpy(counts[lo:hi]).to(device)[:, None]
        anime[offsets[lo]:offsets[hi]] = top[keep]
    users = torch.repeat_interleave(torch.arange(n_users, device=device),
                                    torch.from_numpy(counts).to(device))
    affinity = torch.empty(n, device=device)
    step = KEY_ELEMENTS // LATENT
    for lo in range(0, n, step):
        sl = slice(lo, min(lo + step, n))
        affinity[sl] = (u_lat[users[sl]] * a_lat[anime[sl]]).sum(1)
    noise = torch.randn(n, generator=g, device=device) * NOISE
    score = torch.sigmoid(affinity * TEACHER_GAIN + noise)
    raw = torch.clamp(torch.round(1 + 9 * score), 1, 10)
    lo_r, hi_r = raw.min(), raw.max()
    scaled = ((raw - lo_r) / torch.clamp_min(hi_r - lo_r, 1)).float()
    return Ratings(users, anime, scaled, raw.to(torch.int8), counts, offsets)


def holdout_split(n: int, test_size: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(train rows, holdout rows): a seeded shuffle of the n rows, the last
    ``test_size`` held out, as the reference's get_df does."""
    order = np.random.default_rng(sub_seeds(seed)[2]).permutation(n)
    return order[:n - test_size], order[n - test_size:]


@torch.no_grad()
def weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The model's parameters and BatchNorm buffers at Keras's initialisation,
    drawn on ``device``: tables uniform(-0.05, 0.05), the dense weight a
    normal truncated to [-2, 2] times sqrt(2) (he_normal on fan-in 1), the
    rest Keras's constants. Under the names of the port's .npz files."""
    s = sub_seeds(seed)
    g = torch.Generator(device=device).manual_seed(s[3])
    d = cfg["embedding_size"]
    out = {k: torch.rand(n, d, generator=g, device=device).mul_(0.1).sub_(0.05)
           for k, n in (("user_emb", cfg["n_users"]), ("anime_emb", cfg["n_anime"]))}
    rng = np.random.default_rng(s[4])
    w = rng.normal()
    while abs(w) > 2.0:
        w = rng.normal()
    for k, v in (("dense_w", w * 2 ** 0.5), ("dense_b", 0.0), ("bn_gamma", 1.0),
                 ("bn_beta", 0.0), ("moving_mean", 0.0), ("moving_var", 1.0)):
        out[k] = torch.tensor(v, dtype=torch.float32, device=device)
    return out


def catalog_frames(cfg: dict, seed: int) -> tuple[pd.DataFrame, pd.DataFrame]:
    """all_anime.csv- and synopses.csv-shaped frames (the raw schemas). A
    seeded share ``assumed.missing_from_catalog`` of the anime is left out
    of the catalog, as trained anime without a catalog row are in the real
    data; about a tenth of the rest have no synopsis."""
    n = cfg["n_anime"]
    rng = np.random.default_rng(sub_seeds(seed)[5])
    present = np.sort(rng.permutation(n)[: n - int(n * cfg["assumed"]["missing_from_catalog"])])
    m = len(present)
    names = [f"Anime {i:05d}" if i % 97 else f"Anime☆{i:05d}" for i in present]
    n_genres = rng.integers(1, 5, m)
    genre_idx = np.argsort(rng.random((m, len(GENRES))), axis=1)
    genres = [", ".join(sorted(GENRES[j] for j in genre_idx[i, :n_genres[i]]))
              for i in range(m)]
    episodes = rng.integers(1, 60, m).astype(object)
    episodes[::53] = "Unknown"
    score = np.round(rng.uniform(4.0, 9.5, m), 2).astype(object)
    score[::71] = "Unknown"
    seasons = np.array(["Winter", "Spring", "Summer", "Fall"])
    anime = pd.DataFrame({
        "MAL_ID": present * ANIME_ID_STRIDE + ANIME_ID_BASE,
        "Name": names,
        "English name": names,
        "Japanese name": [f"アニメ{i:05d}" for i in present],
        "Score": score,
        "Genres": genres,
        "Type": rng.choice(TYPES, m, p=TYPE_P),
        "Episodes": episodes,
        "Premiered": [f"{a} {b}" for a, b in zip(seasons[rng.integers(0, 4, m)],
                                                 rng.integers(1990, 2023, m))],
        "Studios": rng.choice(STUDIOS, m),
        "Source": rng.choice(SOURCES, m),
        "Rating": rng.choice(RATINGS, m),
        "Members": rng.integers(1000, 2_000_000, m),
    })
    keep = rng.random(m) > 0.1
    synopses = pd.DataFrame({
        "MAL_ID": anime["MAL_ID"].to_numpy()[keep],
        "Name": np.asarray(names, object)[keep],
        "Genres": np.asarray(genres, object)[keep],
        "sypnopsis": [f"Synopsis of {a}: a tale of {g.split(',')[0].lower()}."
                      for a, g in zip(np.asarray(names, object)[keep],
                                      np.asarray(genres, object)[keep])],
    })
    return anime, synopses


def user_ids(rows: np.ndarray) -> np.ndarray:
    return np.asarray(rows, np.int64) * USER_ID_STRIDE + USER_ID_BASE


def anime_ids(rows: np.ndarray) -> np.ndarray:
    return np.asarray(rows, np.int64) * ANIME_ID_STRIDE + ANIME_ID_BASE
