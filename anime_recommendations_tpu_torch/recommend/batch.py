"""Batched retrieval entry points.

Counterpart of anime_recommendations_tpu/recommend/batch.py: many queries
ride one scan of the table, then one vectorized metadata join. The ids of a
whole batch are translated at once, raw ids to vocab rows before the scan
and vocab rows to catalog rows after it, against the context's indexes
(RecContext.user_indices, anime_indices, catalog_positions).

model_recs_batch reads its users' watched sets as slices of their sorted
rating rows (RecContext.watched_rows), tests the scan's rows against them in
one vectorized pass, and scans for k rounded up to one of a few sizes an
octave (scan_k), so that the scan's signature, and its captured graph, do
not change with every batch.

Spans (utils/profiling.span), each around a whole batch: ``recommend.encode``
(raw ids to rows), ``recommend.masks`` (the shared mask and watched sets),
``scan.call`` (ops/topk.host_topk) and ``recommend.join`` (the records);
encode and join carry the batch's size as ``ids``.
"""

from __future__ import annotations

import numpy as np

from anime_recommendations_tpu_torch.ops.scoring import score_topk
from anime_recommendations_tpu_torch.ops.topk import cosine_topk, host_topk
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.utils.profiling import span


K_BITS = 3    # scan_k keeps this many leading bits of k


def scan_k(k: int) -> int:
    """``k`` rounded up to a number with at most its K_BITS leading bits
    set (..., 12, 14, 16, 20, 24, 28, 32, 40, ...): four sizes an octave, at
    most 25 % over."""
    step = 1 << max(0, k.bit_length() - K_BITS)
    return -(-k // step) * step


def _watched_keys(watched: tuple[np.ndarray, np.ndarray], n_rows: int) -> np.ndarray:
    """The watched sets (RecContext.watched_rows) as sorted distinct keys
    ``query * n_rows + row``."""
    offsets, rows = watched
    owner = np.repeat(np.arange(len(offsets) - 1, dtype=np.int64), np.diff(offsets))
    keys = np.sort(owner * n_rows + rows)
    return keys[np.concatenate([[True], keys[1:] != keys[:-1]])]


def _kept(vals: np.ndarray, idx: np.ndarray, watched: np.ndarray, n_rows: int,
          n: int) -> np.ndarray:
    """Each row's kept scan rows (live, and not among ``watched``, its
    user's _watched_keys) over a prefix of the columns that holds its first
    ``n`` kept rows, or over all of them: the columns are tested from ``2 n``
    on, doubling, and a row stops once it keeps ``n`` (False past its
    prefix), so the cost is set by ``n`` and the rows that watched most of
    their best rows, not by ``k``."""
    total = vals.shape[1]
    width = min(2 * n, total)
    keep = np.zeros((vals.shape[0], width), bool)
    rows = np.arange(vals.shape[0])
    lo = 0
    while True:
        keys = rows[:, None] * n_rows + np.clip(idx[rows, lo:width], 0, None)
        at = np.minimum(np.searchsorted(watched, keys), max(len(watched) - 1, 0))
        seen = watched[at] == keys if len(watched) else np.zeros(keys.shape, bool)
        keep[rows, lo:width] = (vals[rows, lo:width] > -1e29) & ~seen
        rows = rows[keep[rows].sum(1) < n]
        if width == total or not len(rows):
            return keep
        lo, width = width, min(2 * width, total)
        keep = np.pad(keep, ((0, 0), (0, width - lo)))


def _join(ctx: RecContext, vals: np.ndarray, idx: np.ndarray, keep: np.ndarray,
          sel: np.ndarray) -> tuple[list, list, list]:
    """The catalog records of every query's ``sel`` scan rows, in one lookup:
    per query, the anime ids and names of their catalog rows (each anime's
    every row in catalog order, anime absent from the catalog dropped, scan
    order kept), and as many scores as records from the query's ``keep``
    rows, first first: the JAX package's ``rows_for_ids`` join, one query at
    a time, and its ``vals[row][keep][: len(rows)]``. ``keep`` and ``sel``
    may cover a prefix of the columns that holds those scores."""
    vals, idx = vals[:, :keep.shape[1]], idx[:, :keep.shape[1]]
    pos, per_row = ctx.catalog_positions(idx[sel])
    ends = np.concatenate([[0], np.cumsum(per_row)])
    records = np.diff(ends[np.concatenate([[0], np.cumsum(sel.sum(1))])])
    scored = keep & (np.cumsum(keep, axis=1) <= records[:, None])
    cols = ctx.catalog.column_arrays
    return (_split(cols["anime_id"][pos], records), _split(cols["Name"][pos], records),
            _split(vals[scored], scored.sum(1)))


def _split(flat: np.ndarray, counts: np.ndarray) -> list[list]:
    """``flat`` as Python values, cut into consecutive lists of ``counts``."""
    values = flat.tolist()
    ends = np.cumsum(counts).tolist()
    return [values[a:b] for a, b in zip([0] + ends, ends)]


def similar_anime_batch(
    ctx: RecContext,
    names: list,
    count: int = 10,
    types: list[str] | None = None,
    genres: list | None = None,
) -> list[dict]:
    """Similar-anime for many queries in one scan.

    Returns one record per query: {"query", "anime_ids", "names",
    "similarities"}. Unknown names raise KeyError.
    """
    with span("recommend.encode") as s:
        s.annotate(ids=len(names))
        q_idx = ctx.anime_indices([ctx.catalog.resolve_query(n) for n in names])

    with span("recommend.masks"):
        mask = ctx.in_catalog_mask()
        if types is not None:
            mask &= ctx.type_mask(types)
        if genres is not None:
            mask &= ctx.genre_mask(genres)

    vals, idx = host_topk(
        cosine_topk,
        ctx.anime_table(),
        ctx.anime_vectors(q_idx),
        k=min(count, ctx.vocab.n_anime),
        mask=mask,
        exclude=q_idx,
        graphs=ctx.scan_graphs,
        **ctx.topk_kwargs,
    )
    with span("recommend.join") as s:
        s.annotate(ids=len(names))
        keep = vals > -1e29
        anime_ids, titles, scores = _join(ctx, vals, idx, keep, keep)
        return [
            {"query": name, "anime_ids": a, "names": t, "similarities": v}
            for name, a, t, v in zip(names, anime_ids, titles, scores)
        ]


def model_recs_batch(
    ctx: RecContext,
    user_ids: list[int],
    n_recs: int = 10,
    types: list[str] | None = None,
    genres: list | None = None,
) -> list[dict]:
    """Model-predicted top-n for many users in one scan. The scan's shared
    row mask holds the common filters; each user's watched set is dropped
    afterwards, so the scan asks for ``n_recs + max watched`` candidates,
    rounded up by scan_k.
    """
    with span("recommend.encode") as s:
        s.annotate(ids=len(user_ids))
        user_idx = ctx.user_indices(user_ids)

    with span("recommend.masks"):
        shared = ctx.in_catalog_mask()
        if types is not None:
            shared &= ctx.type_mask(types)
        if genres is not None:
            shared &= ctx.genre_mask(genres)
        n_rows = ctx.vocab.n_anime
        watched = _watched_keys(ctx.watched_rows(user_ids), n_rows)
        counts = np.bincount(watched // n_rows, minlength=len(user_ids))
        buffer = int(counts.max()) if len(user_ids) else 0
    k = min(scan_k(min(n_recs + buffer, n_rows)), n_rows)

    vals, idx = host_topk(
        score_topk,
        ctx.anime_table(),
        ctx.user_vectors(user_idx),
        ctx.head,
        k=k,
        mask=shared,
        graphs=ctx.scan_graphs,
        **ctx.topk_kwargs,
    )
    with span("recommend.join") as s:
        s.annotate(ids=len(user_ids))
        # A record's score is one of its user's first kept rows, and its
        # n_recs selected anime have at most catalog_repeats rows each.
        keep = _kept(vals, idx, watched, n_rows, n_recs * ctx.catalog_repeats)
        sel = keep & (np.cumsum(keep, axis=1) <= n_recs)
        anime_ids, titles, scores = _join(ctx, vals, idx, keep, sel)
        return [
            {"user_id": int(uid), "anime_ids": a, "names": t, "predictions": v}
            for uid, a, t, v in zip(user_ids, anime_ids, titles, scores)
        ]


def similar_users_batch(
    ctx: RecContext,
    user_ids: list[int],
    n_users: int = 10,
    num_faves: int = 2,
    TV_only: bool = True,
    include_faves: bool = True,
) -> list[dict]:
    """Similar-users for many query users in one scan (each query excludes
    itself), then the favorite-anime summaries per result row.
    ``include_faves=False`` skips the favorites strings. Returns one record
    per query: {"query", "similar_users", "similarities"[,
    "favorite_animes"]}. Unknown users raise KeyError.
    """
    from anime_recommendations_tpu_torch.recommend.similar_users import get_fave_anime

    with span("recommend.encode") as s:
        s.annotate(ids=len(user_ids))
        q_idx = ctx.user_indices([int(u) for u in user_ids])
    vals, idx = host_topk(
        cosine_topk,
        ctx.user_table(),
        ctx.user_vectors(q_idx),
        k=min(n_users, ctx.vocab.n_users),
        exclude=q_idx,
        graphs=ctx.scan_graphs,
        **ctx.topk_kwargs,
    )
    out = []
    with span("recommend.join") as s:
        s.annotate(ids=len(user_ids))
        keep = vals > -1e29
        counts = keep.sum(1)
        similar = _split(ctx.vocab.user_ids[idx[keep]], counts)
        for uid, sim_ids, sims in zip(user_ids, similar, _split(vals[keep], counts)):
            rec = {"query": int(uid), "similar_users": sim_ids, "similarities": sims}
            if include_faves:
                rec["favorite_animes"] = [
                    get_fave_anime(ctx, u, num_faves, TV_only) for u in sim_ids
                ]
            out.append(rec)
    return out
