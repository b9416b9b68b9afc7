"""Anime metadata catalog: names, genres, types, sources, synopses.

A copy of anime_recommendations_tpu/data/catalog.py, so that the port loads
nothing of the JAX package: one object holding the cleaned all_anime.csv
frame, the synopses, name resolution and vectorized genre/type filters.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from functools import cached_property
from pathlib import Path

import numpy as np
import pandas as pd

from anime_recommendations_tpu_torch.utils.text import clean_name, clean_names

ANIME_TYPES = ("TV", "OVA", "Movie", "Special", "ONA", "Music")

_KEEP_COLS = [
    "anime_id", "eng_version", "Score", "Genres", "Episodes", "Premiered",
    "Studios", "japanese_name", "Name", "Type", "Source", "Rating", "Members",
]


@dataclass
class Catalog:
    anime: pd.DataFrame               # cleaned anime frame, _KEEP_COLS, Score-desc
    synopses: pd.DataFrame | None = None  # MAL_ID, Name, Genres, sypnopsis
    _by_id: pd.DataFrame = field(default=None, repr=False)
    _syn_by_id: pd.Series = field(default=None, repr=False)

    def __post_init__(self):
        self._by_id = self.anime.set_index("anime_id", drop=False)
        if self.synopses is not None:
            syn = self.synopses.drop_duplicates(subset="MAL_ID")
            self._syn_by_id = syn.set_index("MAL_ID")["sypnopsis"]

    @cached_property
    def _genre_key(self) -> pd.Series:
        """Lowercased, space-stripped genre strings for substring matching
        (the original project's membership test, similar_anime.py:307-308),
        made at the first genre filter."""
        return self.anime["Genres"].astype(str).str.lower().str.replace(" ", "", regex=False)

    # ---- constructors ---------------------------------------------------------

    @classmethod
    def from_files(
        cls, anime_csv: str | Path, synopses_csv: str | Path | None = None
    ) -> "Catalog":
        anime = load_anime_frame(pd.read_csv(anime_csv))
        synopses = None
        if synopses_csv is not None and Path(synopses_csv).exists():
            synopses = pd.read_csv(
                synopses_csv, usecols=["MAL_ID", "Name", "Genres", "sypnopsis"]
            )
        return cls(anime=anime, synopses=synopses)

    @classmethod
    def from_frames(
        cls, anime_raw: pd.DataFrame, synopses: pd.DataFrame | None = None
    ) -> "Catalog":
        return cls(anime=load_anime_frame(anime_raw), synopses=synopses)

    # ---- lookups --------------------------------------------------------------

    def name_of(self, anime_id: int) -> str:
        return self._by_id.loc[anime_id, "Name"]

    @cached_property
    def _syn_dict(self) -> dict:
        """id -> synopsis as a plain dict: the serve path looks synopses up
        per result row, and a hash probe beats a pandas .loc by ~30x."""
        return {} if self._syn_by_id is None else self._syn_by_id.to_dict()

    def synopsis_of(self, anime_id: int) -> str:
        """Synopsis text, or "None" when absent (similar_anime.py:420-423)."""
        return self._syn_dict.get(anime_id, "None")

    @cached_property
    def _name_maps(self) -> tuple[dict, dict]:
        """(Name -> anime_id, eng_version -> anime_id), FIRST catalog row
        wins — the original project's ``hit["anime_id"].values[0]`` over a
        Score-sorted frame. Hash maps replace the per-query full-column
        equality scans (two ~N-row string compares per resolve)."""
        first_n = self.anime.drop_duplicates(subset="Name")
        first_e = self.anime.drop_duplicates(subset="eng_version")
        return (
            dict(zip(first_n["Name"], first_n["anime_id"])),
            dict(zip(first_e["eng_version"], first_e["anime_id"])),
        )

    def resolve_query(self, name: str | int) -> int:
        """Resolve an anime name to its ID with the original project's 3-stage
        fallback (similar_anime.py:387-396 + get_anime_frame :228-240):
        (1) cleaned query vs raw Name column, (2) raw query vs raw Name
        ("in case the name has special characters"), (3) cleaned query vs
        the CLEANED eng_version column — the punctuation-typo-tolerant
        match ("in case there is a punctuation typo in the config file").
        Integers are treated as anime IDs directly (get_anime_frame int
        branch)."""
        if isinstance(name, (int, np.integer)):
            if int(name) not in self._by_id.index:
                raise KeyError(f"Unknown anime id: {name}")
            return int(name)
        by_name, by_eng = self._name_maps
        translated = clean_name(name)
        hit = by_name.get(translated, by_name.get(name, by_eng.get(translated)))
        if hit is None:
            raise KeyError(f"Unknown anime: {name!r}")
        return int(hit)

    # ---- vectorized position machinery (serve-path hot lookups) ---------------

    @cached_property
    def _aid_positions(self) -> tuple[np.ndarray, np.ndarray]:
        """(anime_id sorted ascending, catalog row positions in that order):
        searchsorted ranges replace whole-catalog ``isin`` scans for the
        per-user favorites selection (the original project's
        anime_df[anime_df.anime_id.isin(top)] — user_prefs.py:222-240)."""
        aid = np.asarray(self.anime["anime_id"].to_numpy(), dtype=np.int64)
        order = np.argsort(aid, kind="stable")
        return aid[order], order.astype(np.int64)

    def positions_for_ids(self, anime_ids: np.ndarray) -> np.ndarray:
        """Catalog row positions (ascending = catalog order) of every row
        whose anime_id is in ``anime_ids`` — exact ``isin`` semantics,
        including duplicate catalog rows per id; absent ids contribute
        nothing."""
        return np.sort(self.positions_csr(np.unique(np.asarray(anime_ids, np.int64)))[1])

    def positions_for_ids_ordered(
        self, anime_ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(positions, src) for ``anime_ids`` preserving INPUT order —
        rows_for_ids semantics as position arrays: every catalog row per id
        (duplicates in catalog order), absent ids dropped; src[j] is the
        index into ``anime_ids`` that produced output row j (for aligning
        per-id extras like similarity scores)."""
        offsets, pos = self.positions_csr(anime_ids)
        return pos, np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))

    def positions_csr(self, anime_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(offsets, positions): the catalog row positions of ``anime_ids[j]``
        are ``positions[offsets[j]:offsets[j + 1]]`` — every catalog row of
        the id, in catalog order; none for an id absent from the catalog."""
        aid_sorted, pos = self._aid_positions
        ids = np.asarray(anime_ids, dtype=np.int64)
        lo = np.searchsorted(aid_sorted, ids, "left")
        counts = np.searchsorted(aid_sorted, ids, "right") - lo
        return np.concatenate([[0], np.cumsum(counts)]), pos[ranges(lo, counts)]

    @cached_property
    def column_arrays(self) -> dict[str, np.ndarray]:
        """Catalog columns as position-indexable numpy arrays — the serve
        enrichment path gathers k result rows from these instead of paying
        a pandas .loc + per-column extraction per request. Each column is
        converted at its first read (a batch join reads two of thirteen)."""
        return _Columns(self.anime)

    @cached_property
    def episodes_numeric(self) -> np.ndarray:
        """Episodes per catalog row as float32 (NaN where unparseable) —
        the favorite-anime tie-break key, precomputed once."""
        return pd.to_numeric(
            self.anime["Episodes"], errors="coerce"
        ).to_numpy(np.float32)

    @cached_property
    def eng_values(self) -> np.ndarray:
        """eng_version per catalog row (object array, position-indexable)."""
        return self.anime["eng_version"].to_numpy()

    @cached_property
    def eng_lookup(self) -> pd.DataFrame:
        """First catalog row per eng_version, indexed by eng_version — the
        user_recs enrichment join, built once instead of per request
        (the original project's get_anime_frame clean=True semantics)."""
        return self.anime.drop_duplicates(subset="eng_version").set_index(
            "eng_version"
        )

    @cached_property
    def eng_first_pos(self) -> dict:
        """eng_version -> FIRST catalog row position (the eng_lookup join
        as a hash map over the cached column arrays)."""
        out: dict = {}
        for i, v in enumerate(self.eng_values):
            if v not in out:
                out[v] = i
        return out

    # ---- genre / type machinery ----------------------------------------------

    def all_genres(self) -> list[str]:
        """Reference get_genres() (similar_anime.py:174-191): split the unique
        genre strings on whitespace, strip non-word chars, re-add the
        multi-word categories, drop their fragments, sort."""
        genres = self.anime["Genres"].unique().tolist()
        possibilities = list(set(str(genres).split()))
        possibilities = sorted(set(re.sub(r"[\W_]", "", e) for e in possibilities))
        rem = ["Slice", "of", "Life", "Martial", "Arts", "Super", "Power", "nan"]
        fixed = possibilities + ["Slice of Life", "Super Power", "Martial Arts", "None"]
        return sorted(i for i in fixed if i not in rem)

    def genre_mask(self, genres: list) -> np.ndarray:
        """Boolean mask over catalog rows matching ANY of up to 3 genres.

        Mirrors by_genre (similar_anime.py:279-340): each genre is cleaned
        and matched as a substring of the lowercased space-stripped Genres
        string; the literal "none" never matches. Raises ValueError on a
        genre not in the catalog's vocabulary (the original project asserts)."""
        use = clean_names([str(g) for g in genres])
        valid = set(clean_names(self.all_genres()))
        for g in use:
            if g not in valid:
                raise ValueError(
                    f"Invalid genre {g!r}; choose from {sorted(valid)}"
                )
        mask = np.zeros(len(self.anime), dtype=bool)
        for g in use:
            if g == "none":
                continue
            mask |= self._genre_key.str.contains(re.escape(g), regex=True).to_numpy()
        return mask

    def type_mask(self, types: list[str]) -> np.ndarray:
        """Boolean mask over catalog rows whose Type is in ``types``
        (similar_anime.py:343-358 validation + :439-441 filter)."""
        for t in types:
            if t not in ANIME_TYPES:
                raise ValueError(f"Invalid type {t!r}; choose from {ANIME_TYPES}")
        return self.anime["Type"].isin(types).to_numpy()

    def genre_frequencies(self) -> dict[str, int]:
        """Comma-split genre counts (user_prefs.get_genres, user_prefs.py:95-118)."""
        return _split_frequencies(self.anime["Genres"])

    def source_frequencies(self) -> dict[str, int]:
        """Comma-split source counts (user_prefs.get_sources, user_prefs.py:121-141)."""
        return _split_frequencies(self.anime["Source"])


class _Columns(dict):
    """A frame's columns as numpy arrays, each converted at its first read."""

    def __init__(self, frame: pd.DataFrame):
        super().__init__()
        self._frame = frame

    def __missing__(self, name: str) -> np.ndarray:
        value = self[name] = self._frame[name].to_numpy()
        return value


def ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The concatenation of ``arange(s, s + c)`` over ``zip(starts, counts)``."""
    ends = np.cumsum(counts)
    return np.repeat(np.asarray(starts) - (ends - counts), counts) + np.arange(np.sum(counts))


def load_anime_frame(df: pd.DataFrame) -> pd.DataFrame:
    """Clean a raw all_anime.csv frame (the original get_anime_df semantics):
    "Unknown" -> NaN, derive anime_id/japanese_name, eng_version = cleaned
    canonical Name per ID, sort by Score descending (NaN last)."""
    df = df.replace("Unknown", np.nan)
    df = df.copy()
    df["anime_id"] = df["MAL_ID"]
    df["japanese_name"] = df["Japanese name"]
    # The original project overwrites eng_version with the cleaned *Name* of the
    # first row matching each anime_id (get_anime_name + clean, lowered).
    first_names = df.drop_duplicates(subset="anime_id").set_index("anime_id")["Name"]
    cleaned = pd.Series(clean_names(first_names.tolist()), index=first_names.index, dtype=object)
    df["eng_version"] = df["anime_id"].map(cleaned)
    df = df.sort_values(by=["Score"], ascending=False, kind="quicksort", na_position="last")
    return df[_KEEP_COLS].reset_index(drop=True)


def _split_frequencies(col: pd.Series) -> dict[str, int]:
    out: dict[str, int] = {}
    for entry in col:
        if isinstance(entry, str):
            for token in entry.split(","):
                token = token.strip()
                out[token] = out.get(token, 0) + 1
    return out
