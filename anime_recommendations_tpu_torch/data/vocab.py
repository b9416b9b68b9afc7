"""First-appearance ID vocabularies.

A copy of anime_recommendations_tpu/data/vocab.py, so that the port loads
nothing of the JAX package. User and anime IDs are numbered by first
appearance in the preprocessed frame; embedding-table rows are addressed by
that order, and ``vocab.json`` written by either package loads in both.
"""

from __future__ import annotations

from dataclasses import dataclass

import json
from pathlib import Path

import numpy as np
import pandas as pd


@dataclass(frozen=True)
class Vocab:
    """Bidirectional mapping between raw IDs and dense embedding rows."""

    user_ids: np.ndarray   # raw user id at each dense index (first-appearance order)
    anime_ids: np.ndarray  # raw anime id at each dense index

    @property
    def n_users(self) -> int:
        return len(self.user_ids)

    @property
    def n_anime(self) -> int:
        return len(self.anime_ids)

    # Dict views ({id: index} / {index: id}).
    def user_to_index(self) -> dict[int, int]:
        return {int(v): i for i, v in enumerate(self.user_ids)}

    def anime_to_index(self) -> dict[int, int]:
        return {int(v): i for i, v in enumerate(self.anime_ids)}

    def encode_users(self, raw: np.ndarray) -> np.ndarray:
        """Vectorized raw-user-id -> dense-index; -1 for unknown IDs."""
        return _encode(self.user_ids, np.asarray(raw))

    def encode_anime(self, raw: np.ndarray) -> np.ndarray:
        return _encode(self.anime_ids, np.asarray(raw))

    def save(self, path: str | Path) -> None:
        Path(path).write_text(
            json.dumps(
                {
                    "user_ids": self.user_ids.tolist(),
                    "anime_ids": self.anime_ids.tolist(),
                }
            )
        )

    @classmethod
    def load(cls, path: str | Path) -> "Vocab":
        raw = json.loads(Path(path).read_text())
        return cls(
            user_ids=np.asarray(raw["user_ids"], dtype=np.int64),
            anime_ids=np.asarray(raw["anime_ids"], dtype=np.int64),
        )


def build_vocab(df: pd.DataFrame) -> Vocab:
    """Enumerate user_id/anime_id by first appearance (pd.unique keeps order)."""
    return Vocab(
        user_ids=np.asarray(pd.unique(df["user_id"])),
        anime_ids=np.asarray(pd.unique(df["anime_id"])),
    )


def encode_frame(df: pd.DataFrame, vocab: Vocab) -> pd.DataFrame:
    """Add dense 'user'/'anime' index columns (the original project's get_df mapping)."""
    out = df.copy()
    out["user"] = vocab.encode_users(out["user_id"].to_numpy())
    out["anime"] = vocab.encode_anime(out["anime_id"].to_numpy())
    return out


def _encode(table_ids: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """Map raw IDs to dense indices via a sorted-search; unknown -> -1."""
    order = np.argsort(table_ids, kind="stable")
    sorted_ids = table_ids[order]
    pos = np.searchsorted(sorted_ids, raw)
    pos = np.clip(pos, 0, len(sorted_ids) - 1)
    found = sorted_ids[pos] == raw
    dense = np.where(found, order[pos], -1)
    return dense.astype(np.int64)
