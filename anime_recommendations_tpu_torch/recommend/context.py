"""Shared retrieval context.

Counterpart of anime_recommendations_tpu/recommend/context.py: one object
holds the retrieval tables on the device (recommend/tables.py: one copy of
each, the scans', from which query rows are read through its inverse
permutation; tables_report() gives their bytes), the canonical vocab, the
preprocessed rating frame and the catalog, and every recommender reads
from it. The host-side views below are the JAX package's, copied, except
the id translations: a whole batch of raw ids goes to vocab rows
(user_indices, anime_indices), and vocab rows to catalog rows
(catalog_positions), in one lookup against indexes built once per context
(data/vocab.IdIndex; id_index_report() counts their builds and the ids
they translated); and the watched sets, which a batch reads as slices of
the users' sorted rating rows (watched_rows), not as dense masks.

Span (utils/profiling.span): ``context.build`` around RecContext.build,
with one ``context.table`` per table built (recommend/tables.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import pandas as pd
import torch

from anime_recommendations_tpu_torch.data.catalog import Catalog, ranges
from anime_recommendations_tpu_torch.data.vocab import IdIndex, Vocab
from anime_recommendations_tpu_torch.models.two_tower import TwoTower
from anime_recommendations_tpu_torch.ops.ivf import IVFIndex
from anime_recommendations_tpu_torch.ops.quantized import QuantizedTable
from anime_recommendations_tpu_torch.ops.scan_graph import ScanGraphs
from anime_recommendations_tpu_torch.ops.topk import ShuffledTable
from anime_recommendations_tpu_torch.recommend.tables import (
    build_tables,
    logical_rows,
    tables_report,
)
from anime_recommendations_tpu_torch.utils.profiling import span


@dataclass
class RecContext:
    vocab: Vocab
    catalog: Catalog
    ratings: pd.DataFrame          # preprocessed + encoded: user, anime, rating, user_id, anime_id
    head: torch.Tensor             # [2] (alpha, beta) folded eval-mode head
    # The normalized tables, one copy each: what the scans read and where
    # query rows come from (recommend/tables.py).
    anime_scan: ShuffledTable | IVFIndex
    user_scan: ShuffledTable | IVFIndex
    # The int8 scan tables (ops/quantized.py) of an int8 context without
    # IVF; None otherwise.
    anime_qt: QuantizedTable | None = None
    user_qt: QuantizedTable | None = None
    # Keywords merged into every cosine_topk/score_topk call the recommenders
    # make, e.g. {"exact_scan": True}, or an IVF context's {"probes": 16}.
    topk_kwargs: dict = field(default_factory=dict)
    # The captured scans of this context's tables (ops/scan_graph.py): on a
    # card each recommender's scan is one graph replay once its signature
    # is captured. They go with the context, or with release_graphs().
    # ScanGraphs(0) scans eagerly.
    scan_graphs: ScanGraphs = field(default_factory=ScanGraphs, repr=False)
    # The card memory that RecContext.build left allocated (what
    # torch.cuda.memory_allocated grew by); None off the card.
    built_bytes: int | None = field(default=None, repr=False)
    # Vocab anime row -> catalog positions (Catalog.positions_csr), built on
    # first use.
    _catalog_lookup: IdIndex = field(init=False, repr=False)

    def __post_init__(self):
        self._catalog_lookup = IdIndex(self.catalog.positions_csr, self.vocab.anime_ids)

    # ---- constructors ---------------------------------------------------------

    @classmethod
    def build(
        cls,
        model: TwoTower,
        vocab: Vocab,
        catalog: Catalog,
        ratings: pd.DataFrame,
        *,
        device,
        retrieval_dtype=None,
        topk_kwargs: dict | None = None,
        ann: str = "off",
        ann_probes: int = 16,
    ) -> "RecContext":
        """Retrieval numerics: None/"f32" = exact scans; "bf16" halves the
        scan traffic at ~1e-3 score error; "int8" stores the scan tables
        quantized (a quarter of the f32 bytes) and rescores a candidate pool
        in exact f32 (ops/quantized.py). ``topk_kwargs`` go to every scan
        (``{"exact_scan": True}`` for the single exact stage, f32 and bf16
        only). The scans read one shuffled copy of each table, built in
        chunks of the model's rows (recommend/tables.build_tables), and
        query rows are read from it (``anime_vectors``/``user_vectors``; f32
        rows for int8).

        ``ann="ivf"`` scans IVF indexes instead (ops/ivf.py): a query probes
        the top ``ann_probes`` clusters and rescores their rows exactly,
        the sublinear path for tables beyond ~1M rows. Its recall is set by
        ``ann_probes``; probing every cluster is exact for f32 and bf16
        tables (not for int8 storage)."""
        cuda = torch.device(device).type == "cuda"
        before = torch.cuda.memory_allocated(device) if cuda else 0
        with span("context.build"):
            t = build_tables(model, device=device, retrieval_dtype=retrieval_dtype, ann=ann)
        built = torch.cuda.memory_allocated(device) - before if cuda else None
        topk_kwargs = dict(topk_kwargs or {})
        if ann == "ivf":
            topk_kwargs.setdefault("probes", ann_probes)
        return cls(
            vocab=vocab, catalog=catalog, ratings=ratings, head=t.head,
            anime_scan=t.anime_scan, user_scan=t.user_scan,
            anime_qt=t.anime_qt, user_qt=t.user_qt, topk_kwargs=topk_kwargs,
            built_bytes=built,
        )

    @property
    def device(self) -> torch.device:
        return self.head.device

    def release_graphs(self) -> None:
        """Drop the captured scans of this context's tables and their
        memory pools (the next scans capture them anew)."""
        self.scan_graphs.release()

    # ---- retrieval-table accessors --------------------------------------------

    def anime_table(self) -> ShuffledTable | IVFIndex:
        """The anime table to hand to cosine_topk/score_topk."""
        return self.anime_scan

    def user_table(self) -> ShuffledTable | IVFIndex:
        return self.user_scan

    def anime_vectors(self, rows=None) -> torch.Tensor:
        """Normalized anime rows of vocab ``rows`` (None: the whole table in
        vocab order, a copy), read from the scan table
        (recommend/tables.logical_rows)."""
        return logical_rows(self.anime_scan, rows)

    def user_vectors(self, rows=None) -> torch.Tensor:
        return logical_rows(self.user_scan, rows)

    def tables_report(self) -> dict[str, dict]:
        """Per retrieval table, the bytes it holds on the device
        (recommend/tables.tables_report: its normalized rows, its int8 rows
        and its index), and under ``built`` what the build left allocated
        on the card (``device_bytes``) and the copies of the normalized
        rows that this is (``copies``: those bytes less the int8 rows' and
        the indexes', over the normalized rows'; 1.0 for one copy of each,
        a little more for what the model's reader keeps). None off the
        card."""
        sides = {"anime": tables_report(self.anime_scan), "user": tables_report(self.user_scan)}
        held = self.built_bytes
        rows = sum(r["table_bytes"] for r in sides.values())
        rest = sum(r["int8_bytes"] + r["index_bytes"] for r in sides.values())
        copies = None if held is None else (held - rest) / rows
        return dict(sides, built={"device_bytes": held, "copies": copies})

    # ---- per-user views -------------------------------------------------------

    @cached_property
    def _by_user(self):
        return self.ratings.groupby("user_id")

    def user_rows(self, user_id: int) -> pd.DataFrame:
        """All rating rows of one user (reference df[df.user_id == user]);
        an empty frame for an unknown user."""
        try:
            return self._by_user.get_group(user_id)
        except KeyError:
            return self.ratings.iloc[0:0]

    @cached_property
    def _user_csr(self):
        """Per-user rating slices as flat arrays sorted by user_id:
        (uid_sorted, rating, anime_id, anime_vocab_idx, watched_episodes)."""
        uid = np.asarray(self.ratings["user_id"].to_numpy(), dtype=np.int64)
        order = np.argsort(uid, kind="stable")
        we = None
        if "watched_episodes" in self.ratings.columns:
            we = self.ratings["watched_episodes"].to_numpy()[order]
        return (
            uid[order],
            self.ratings["rating"].to_numpy()[order].astype(np.float64),
            np.asarray(self.ratings["anime_id"].to_numpy(), np.int64)[order],
            np.asarray(self.ratings["anime"].to_numpy(), np.int64)[order],
            we,
        )

    def _user_slice(self, user_id: int) -> slice:
        uid_sorted = self._user_csr[0]
        lo = np.searchsorted(uid_sorted, user_id, "left")
        hi = np.searchsorted(uid_sorted, user_id, "right")
        return slice(lo, hi)

    def user_rating_arrays(self, user_id: int):
        """(ratings, anime_ids, anime_vocab_idx) of one user — numpy views,
        original row order within the user preserved (stable sort)."""
        _, r, aid, aenc, _ = self._user_csr
        s = self._user_slice(user_id)
        return r[s], aid[s], aenc[s]

    def user_watched_episodes(self, user_id: int):
        """watched_episodes of one user's rating rows (aligned with
        user_rating_arrays), or None when the frame lacks the column."""
        we = self._user_csr[4]
        return None if we is None else we[self._user_slice(user_id)]

    def favorite_positions(self, user_id: int, percentile: float) -> np.ndarray:
        """Catalog row positions of the user's >= percentile-rated anime,
        in catalog order."""
        r, aid, _ = self.user_rating_arrays(user_id)
        if r.size == 0:
            return np.empty(0, np.int64)
        cut = np.percentile(r, float(percentile))
        return self.catalog.positions_for_ids(aid[r >= cut])

    def random_user(self, rng: np.random.Generator | None = None) -> int:
        """A user id of the vocab, drawn as the JAX package draws it (one
        rng.integers), so one seed picks the same user in both."""
        rng = rng or np.random.default_rng()
        return int(self.vocab.user_ids[rng.integers(len(self.vocab.user_ids))])

    def random_anime_name(self, rng: np.random.Generator | None = None) -> str:
        """A catalog title, drawn as the JAX package draws it."""
        rng = rng or np.random.default_rng()
        names = self.catalog.anime["Name"].unique()
        return str(names[rng.integers(len(names))])

    # ---- masks over vocab rows ------------------------------------------------

    @cached_property
    def _vocab_anime_meta(self) -> pd.DataFrame:
        # Catalog metadata aligned to vocab rows (NaN rows for anime that are
        # trained but absent from the catalog; an anime's first catalog row
        # where the catalog repeats its id).
        meta = self.catalog.anime.set_index("anime_id", drop=False)
        meta = meta[~meta.index.duplicated()]
        return meta.reindex(self.vocab.anime_ids)

    def vocab_meta(self) -> pd.DataFrame:
        """Catalog metadata frame aligned to anime-vocab row order."""
        return self._vocab_anime_meta

    @cached_property
    def _in_catalog(self) -> np.ndarray:
        # A vocab anime is in the catalog where it has a catalog row.
        offsets, _ = self._catalog_lookup.get(0)
        return np.diff(offsets) > 0

    def in_catalog_mask(self) -> np.ndarray:
        """Vocab rows whose anime exists in the catalog. Returns a fresh
        copy — callers &= filters into it."""
        return self._in_catalog.copy()

    def type_mask(self, types: list[str]) -> np.ndarray:
        """Vocab-row mask for catalog Type membership."""
        catalog_mask = np.array(self.catalog.type_mask(list(types)))
        return self._catalog_mask_to_vocab(catalog_mask)

    def genre_mask(self, genres: list) -> np.ndarray:
        """Vocab-row mask for the 3-genre restriction."""
        catalog_mask = self.catalog.genre_mask(list(genres))
        return self._catalog_mask_to_vocab(catalog_mask)

    def watched_mask(self, user_id: int) -> np.ndarray:
        """Vocab rows the user has rated."""
        watched = np.zeros(self.vocab.n_anime, dtype=bool)
        _, _, idx = self.user_rating_arrays(user_id)
        watched[idx[idx >= 0]] = True
        return watched

    def watched_rows(self, user_ids) -> tuple[np.ndarray, np.ndarray]:
        """(offsets, rows): the vocab rows user ``user_ids[j]`` has rated
        are ``rows[offsets[j]:offsets[j + 1]]``, in the order of its rating
        rows (an anime outside the vocab, -1, left out): slices of the
        users' sorted rating rows, in one pass."""
        uid_sorted, _, _, aenc, _ = self._user_csr
        ids = np.asarray(user_ids, np.int64)
        lo = np.searchsorted(uid_sorted, ids, "left")
        counts = np.searchsorted(uid_sorted, ids, "right") - lo
        rows = aenc[ranges(lo, counts)]
        known = rows >= 0
        kept_before = np.concatenate([[0], np.cumsum(known)])
        return kept_before[np.concatenate([[0], np.cumsum(counts)])], rows[known]

    def _catalog_mask_to_vocab(self, catalog_mask: np.ndarray) -> np.ndarray:
        ids_ok = set(self.catalog.anime.loc[catalog_mask, "anime_id"].tolist())
        return np.fromiter(
            (int(a) in ids_ok for a in self.vocab.anime_ids),
            dtype=bool,
            count=self.vocab.n_anime,
        )

    # ---- encoded indices ------------------------------------------------------

    def user_indices(self, user_ids) -> np.ndarray:
        """Vocab rows of a sequence of raw user ids, in one lookup; KeyError
        for the first unknown id in the order given."""
        return _known(self.vocab.encode_users(np.asarray(user_ids)), user_ids, "User")

    def anime_indices(self, anime_ids) -> np.ndarray:
        return _known(self.vocab.encode_anime(np.asarray(anime_ids)), anime_ids, "Anime")

    def user_index(self, user_id: int) -> int:
        return int(self.user_indices([user_id])[0])

    def anime_index(self, anime_id: int) -> int:
        return int(self.anime_indices([anime_id])[0])

    def catalog_positions(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(positions, counts): the catalog row positions of the anime at
        vocab ``rows``, ``counts[j]`` of them for ``rows[j]``, in input order
        — each anime's every catalog row in catalog order, none for one
        absent from the catalog (Catalog.rows_for_ids of the JAX package,
        for many rows at once)."""
        rows = np.asarray(rows, np.int64)
        offsets, positions = self._catalog_lookup.get(rows.size)
        lo = offsets[rows]
        counts = offsets[rows + 1] - lo
        return positions[ranges(lo, counts)], counts

    @cached_property
    def catalog_repeats(self) -> int:
        """The most catalog rows one vocab anime has (1 where the catalog
        holds each id once, and where it holds none of them)."""
        offsets, _ = self._catalog_lookup.get(0)
        return max(1, int(np.diff(offsets).max(initial=0)))

    def id_index_report(self) -> dict[str, dict[str, int]]:
        """Builds and ids translated of each id index: raw user and anime
        ids to vocab rows (the vocab's, shared by every context on it) and
        vocab rows to catalog rows. One build each, whatever the traffic;
        more mean an index is being rebuilt."""
        return {"user": self.vocab.user_lookup.report(),
                "anime": self.vocab.anime_lookup.report(),
                "catalog": self._catalog_lookup.report()}


def _known(rows: np.ndarray, ids, what: str) -> np.ndarray:
    unknown = np.flatnonzero(rows < 0)
    if unknown.size:
        raise KeyError(f"{what} {ids[unknown[0]]} not in training vocab")
    return rows
