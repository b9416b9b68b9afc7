"""Inputs of a catalog too large to draw the way datagen.py draws, made from
a run's seed: tens of millions of users and items, a few ratings each.

datagen.py samples each user's items with one key per (user, item), which
at 48M items is one user per call; and it draws each table whole, which
the card cannot hold beside the program's own copy. Here:

* ratings: per-user counts as datagen.user_counts draws them (log-normal,
  summing to the configuration's count); each rating's item drawn from the
  Zipf popularity by inverse CDF, and an item drawn twice for one user drawn
  again until no pair repeats (successive sampling without replacement);
  rows ordered by user, then item. Stars 1..``stars`` from planted rank-16
  factors, min-max scaled to [0, 1] as the port's preprocess does;
* weights: each table in blocks of BLOCK_ROWS rows, block b drawn from a
  generator seeded by (seed, table, b), so that any rows can be drawn again
  without the rest (``SeededTable``): the program reads them through its
  build, the reference block by block, and neither holds a second table;
* catalog: a lean all_anime.csv-shaped frame, a name, a type and genres per
  item drawn vectorised, the other columns of the schema empty.

The same seed gives the same inputs on every device of one kind.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import pandas as pd
import torch

from portbench import datagen

BLOCK_ROWS = 1 << 19          # rows of a table drawn at once
AFFINITY_ROWS = 1 << 22       # ratings whose affinity is computed at once
CATEGORIES = [                # the source's item categories
    "All Beauty", "Amazon Fashion", "Appliances", "Arts Crafts and Sewing", "Automotive",
    "Baby Products", "Beauty and Personal Care", "Books", "CDs and Vinyl",
    "Cell Phones and Accessories", "Clothing Shoes and Jewelry", "Digital Music",
    "Electronics", "Gift Cards", "Grocery and Gourmet Food", "Handmade Products",
    "Health and Household", "Health and Personal Care", "Home and Kitchen",
    "Industrial and Scientific", "Kindle Store", "Magazine Subscriptions", "Movies and TV",
    "Musical Instruments", "Office Products", "Patio Lawn and Garden", "Pet Supplies",
    "Software", "Sports and Outdoors", "Subscription Boxes", "Tools and Home Improvement",
    "Toys and Games", "Video Games",
]
EMPTY_COLUMNS = ("English name", "Japanese name", "Score", "Episodes", "Premiered", "Studios",
                 "Source", "Rating", "Members")


class Ratings(NamedTuple):
    users: torch.Tensor       # [n] int64 user rows, ordered by user, then item
    anime: torch.Tensor       # [n] int64 item rows
    rating: torch.Tensor      # [n] f32, min-max scaled to [0, 1]
    counts: np.ndarray        # [n_users] rows per user
    offsets: np.ndarray       # [n_users + 1] start of each user's rows


@torch.no_grad()
def ratings(cfg: dict, seed: int, device) -> Ratings:
    """The configuration's ratings, drawn on ``device`` from ``seed``."""
    n_users, n_items, n = cfg["n_users"], cfg["n_anime"], cfg["n_ratings"]
    s = datagen.sub_seeds(seed)
    rng = np.random.default_rng(s[0])
    counts = datagen.user_counts(n_users, n_items, n, cfg["assumed"]["count_sigma"], rng)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    ranks = torch.from_numpy(rng.permutation(n_items) + 1.0).to(device)
    cdf = torch.cumsum(ranks.pow_(-datagen.ZIPF), 0)
    cdf /= cdf[-1].clone()
    del ranks
    g = torch.Generator(device=device).manual_seed(s[1])
    users = torch.repeat_interleave(torch.arange(n_users, device=device),
                                    torch.from_numpy(counts).to(device))
    items = torch.empty(n, dtype=torch.int64, device=device)
    todo = torch.arange(n, device=device)
    while len(todo):
        u = torch.rand(len(todo), dtype=torch.float64, generator=g, device=device)
        items[todo] = torch.searchsorted(cdf, u).clamp_(max=n_items - 1)
        keys, order = torch.sort(users * n_items + items)
        repeat = torch.nonzero(keys[1:] == keys[:-1]).squeeze(1) + 1
        todo = order[repeat]
        del keys, order, repeat, u
    keys = torch.sort(users * n_items + items).values
    del cdf, items
    anime = keys % n_items
    del keys
    u_lat = torch.randn(n_users, datagen.LATENT, generator=g, device=device) / datagen.LATENT ** 0.5
    a_lat = torch.randn(n_items, datagen.LATENT, generator=g, device=device) / datagen.LATENT ** 0.5
    affinity = torch.empty(n, device=device)
    for lo in range(0, n, AFFINITY_ROWS):
        sl = slice(lo, min(lo + AFFINITY_ROWS, n))
        affinity[sl] = (u_lat[users[sl]] * a_lat[anime[sl]]).sum(1)
    del u_lat, a_lat
    noise = torch.randn(n, generator=g, device=device) * datagen.NOISE
    score = torch.sigmoid(affinity.mul_(datagen.TEACHER_GAIN).add_(noise))
    del noise
    stars = cfg["assumed"]["stars"]
    raw = torch.clamp(torch.round(1 + (stars - 1) * score), 1, stars)
    lo_r, hi_r = raw.min(), raw.max()
    scaled = ((raw - lo_r) / torch.clamp_min(hi_r - lo_r, 1)).float()
    return Ratings(users, anime, scaled, counts, offsets)


class SeededTable:
    """An [n, d] table of uniform(-0.05, 0.05) rows (Keras's initialisation)
    drawn on ``device`` in blocks of BLOCK_ROWS rows, block b from a
    generator seeded by (``seed``, ``tag``, b): ``table[lo:hi]`` draws the
    blocks that hold the rows (the last one drawn is kept, so that reading
    in order draws each block once)."""

    def __init__(self, n: int, d: int, seed: int, tag: int, device):
        self.shape = (n, d)
        self.device = torch.device(device)
        self._key = (int(seed) % 2**64, tag)
        self._last = (None, None)

    def block(self, b: int) -> torch.Tensor:
        """Rows [b * BLOCK_ROWS, (b + 1) * BLOCK_ROWS) of the table."""
        if self._last[0] != b:
            n, d = self.shape
            rows = min(BLOCK_ROWS, n - b * BLOCK_ROWS)
            state = np.random.SeedSequence([*self._key, b]).generate_state(1, np.uint64)
            g = torch.Generator(device=self.device).manual_seed(int(state[0]) >> 1)
            self._last = (None, None)     # the block before goes first
            self._last = (b, torch.rand(rows, d, generator=g, device=self.device)
                          .mul_(0.1).sub_(0.05))
        return self._last[1]

    def __getitem__(self, rows: slice) -> torch.Tensor:
        lo, hi, step = rows.indices(self.shape[0])
        if step != 1:
            raise ValueError("a SeededTable is read by row ranges")
        parts = []
        for b in range(lo // BLOCK_ROWS, -(-hi // BLOCK_ROWS)):
            b0 = b * BLOCK_ROWS
            parts.append(self.block(b)[max(lo, b0) - b0:min(hi, b0 + BLOCK_ROWS) - b0])
        if not parts:
            return torch.empty(0, self.shape[1], device=self.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def release(self) -> None:
        self._last = (None, None)


class SeededModel:
    """The two-tower model at its initialisation, with tables that are
    drawn, not held (SeededTable), and the head as datagen.weights draws it:
    what RecContext.build reads (its tables by row ranges, its head
    scalars)."""

    def __init__(self, cfg: dict, seed: int, device):
        d = cfg["embedding_size"]
        s = datagen.sub_seeds(seed)
        self.user_emb = SeededTable(cfg["n_users"], d, s[3], 0, device)
        self.anime_emb = SeededTable(cfg["n_anime"], d, s[3], 1, device)
        head = datagen.weights(dict(cfg, n_users=0, n_anime=0), seed, device)
        for k in ("dense_w", "dense_b", "bn_gamma", "bn_beta", "moving_mean", "moving_var"):
            setattr(self, k, head[k])

    def release(self) -> None:
        self.user_emb.release()
        self.anime_emb.release()


def item_names(rows: np.ndarray, width: int) -> list[str]:
    """"Item " and each row, zero-padded to ``width`` digits: written as one
    byte buffer and split, at C speed for tens of millions of names."""
    buf = np.full((len(rows), 5 + width + 1), ord("\n"), np.uint8)
    buf[:, :5] = np.frombuffer(b"Item ", np.uint8)
    rest = np.asarray(rows, np.int64).copy()
    for col in range(5 + width - 1, 4, -1):
        buf[:, col] = ord("0") + rest % 10
        rest //= 10
    return buf.tobytes().decode("ascii").split("\n")[:len(rows)]


def catalog_frame(cfg: dict, seed: int) -> pd.DataFrame:
    """An all_anime.csv-shaped frame of every item bar a seeded share
    ``assumed.missing_from_catalog``: a name, a type and one or two of the
    source's categories as its genres, drawn vectorised; the schema's other
    columns empty (NaN)."""
    n = cfg["n_anime"]
    rng = np.random.default_rng(datagen.sub_seeds(seed)[5])
    present = np.sort(rng.permutation(n)[: n - int(n * cfg["assumed"]["missing_from_catalog"])])
    m = len(present)
    names = item_names(present, len(str(n - 1)))
    pairs = np.array([a if a == b else ", ".join(sorted((a, b)))
                      for a in CATEGORIES for b in CATEGORIES], object)
    frame = pd.DataFrame({
        "MAL_ID": datagen.anime_ids(present),
        "Name": names,
        "Genres": pairs[rng.integers(0, len(pairs), m)],
        "Type": np.asarray(datagen.TYPES, object)[rng.choice(len(datagen.TYPES), m,
                                                              p=datagen.TYPE_P)],
    })
    for col in EMPTY_COLUMNS:
        frame[col] = np.nan
    return frame
