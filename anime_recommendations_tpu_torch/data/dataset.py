"""Training dataset: split + static-shape minibatch iteration.

A copy of anime_recommendations_tpu/data/dataset.py, so that the port loads
nothing of the JAX package (numpy and pandas only).

Split parity with the reference's get_df: the frame is shuffled once with
seed 42 (``df.sample``), and the holdout is the LAST ``test_size`` rows.
Every batch has the same shape; the final ragged batch is padded and carries
a weight vector that zeroes its padded rows in the loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import pandas as pd


@dataclass(frozen=True)
class Batch:
    users: np.ndarray    # int32 [B]
    anime: np.ndarray    # int32 [B]
    ratings: np.ndarray  # float32 [B]
    weights: np.ndarray  # float32 [B]; 0.0 marks padding


@dataclass
class RatingsDataset:
    users: np.ndarray
    anime: np.ndarray
    ratings: np.ndarray

    def __len__(self) -> int:
        return len(self.users)

    @classmethod
    def from_frame(cls, df: pd.DataFrame) -> "RatingsDataset":
        return cls(
            users=df["user"].to_numpy(np.int32),
            anime=df["anime"].to_numpy(np.int32),
            ratings=df["rating"].to_numpy(np.float32),
        )

    def num_batches(self, batch_size: int) -> int:
        return -(-len(self) // batch_size)

    def iter_batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = False,
    ) -> Iterator[Batch]:
        n = len(self)
        idx = np.arange(n)
        if shuffle:
            rng = np.random.default_rng(seed)
            rng.shuffle(idx)
        n_full = n // batch_size
        end_full = n_full * batch_size
        for start in range(0, end_full, batch_size):
            sel = idx[start:start + batch_size]
            yield Batch(
                users=self.users[sel],
                anime=self.anime[sel],
                ratings=self.ratings[sel],
                weights=np.ones(batch_size, np.float32),
            )
        rem = n - end_full
        if rem and not drop_remainder:
            sel = idx[end_full:]
            pad = batch_size - rem
            sel_padded = np.concatenate([sel, np.zeros(pad, dtype=sel.dtype)])
            w = np.concatenate([np.ones(rem, np.float32), np.zeros(pad, np.float32)])
            yield Batch(
                users=self.users[sel_padded],
                anime=self.anime[sel_padded],
                ratings=self.ratings[sel_padded],
                weights=w,
            )


def shuffle_frame(df: pd.DataFrame, seed: int = 42) -> pd.DataFrame:
    """Reference get_df shuffle: df.sample(frac=1, random_state=seed)."""
    return df.sample(frac=1, random_state=seed)


def train_holdout_split(
    df: pd.DataFrame, test_size: int = 10_000, shuffle_seed: int = 42
) -> tuple[RatingsDataset, RatingsDataset]:
    """Shuffle with ``shuffle_seed``; last ``test_size`` rows become holdout."""
    df = shuffle_frame(df, seed=shuffle_seed)
    ds = RatingsDataset.from_frame(df)
    cut = max(len(ds) - int(test_size), 0)
    train = RatingsDataset(ds.users[:cut], ds.anime[:cut], ds.ratings[:cut])
    test = RatingsDataset(ds.users[cut:], ds.anime[cut:], ds.ratings[cut:])
    return train, test
