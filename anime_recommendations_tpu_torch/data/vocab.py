"""First-appearance ID vocabularies.

A copy of anime_recommendations_tpu/data/vocab.py, so that the port loads
nothing of the JAX package. User and anime IDs are numbered by first
appearance in the preprocessed frame; embedding-table rows are addressed by
that order, and ``vocab.json`` written by either package loads in both.
Raw ids are translated to rows through a sorter of each id column, built
once on first use (IdIndex) and shared by every lookup after it.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import pandas as pd


class IdIndex:
    """A lookup between two id spaces, built by ``build(*args)`` on its first
    use, once, and shared by every caller after it (threads included). It
    counts its builds and the ids translated through it (report())."""

    def __init__(self, build, *args):
        self._build, self._args = build, args
        self._value = None
        self._lock = threading.Lock()
        self.builds = 0
        self.translated = 0

    def get(self, n_ids: int):
        """The built lookup, counting ``n_ids`` ids translated through it."""
        with self._lock:
            if self._value is None:
                self._value = self._build(*self._args)
                self.builds += 1
            self.translated += n_ids
        return self._value

    def report(self) -> dict[str, int]:
        return {"builds": self.builds, "ids": self.translated}


@dataclass(frozen=True)
class Vocab:
    """Bidirectional mapping between raw IDs and dense embedding rows."""

    user_ids: np.ndarray   # raw user id at each dense index (first-appearance order)
    anime_ids: np.ndarray  # raw anime id at each dense index
    # The sorters of user_ids and anime_ids (_sorter), built on first use.
    user_lookup: IdIndex = field(init=False, repr=False, compare=False)
    anime_lookup: IdIndex = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "user_lookup", IdIndex(_sorter, self.user_ids))
        object.__setattr__(self, "anime_lookup", IdIndex(_sorter, self.anime_ids))

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
        raw = np.asarray(raw)
        return _encode(self.user_lookup.get(raw.size), raw)

    def encode_anime(self, raw: np.ndarray) -> np.ndarray:
        raw = np.asarray(raw)
        return _encode(self.anime_lookup.get(raw.size), raw)

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


def _sorter(table_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(stable argsort of the ids, the ids in that order)."""
    order = np.argsort(table_ids, kind="stable")
    return order, table_ids[order]


def _encode(sorter: tuple[np.ndarray, np.ndarray], raw: np.ndarray) -> np.ndarray:
    """Map raw IDs to dense indices via a sorted-search; unknown -> -1."""
    order, sorted_ids = sorter
    pos = np.searchsorted(sorted_ids, raw)
    pos = np.clip(pos, 0, len(sorted_ids) - 1)
    found = sorted_ids[pos] == raw
    dense = np.where(found, order[pos], -1)
    return dense.astype(np.int64)
