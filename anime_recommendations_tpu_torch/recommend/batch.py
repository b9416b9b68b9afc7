"""Batched retrieval entry points.

Counterpart of anime_recommendations_tpu/recommend/batch.py: many queries
ride one scan of the table, then one vectorized metadata join. The ids of a
whole batch are translated at once, raw ids to vocab rows before the scan
and vocab rows to catalog rows after it, against the context's indexes
(RecContext.user_indices, anime_indices, catalog_positions).

Spans (utils/profiling.span), each around a whole batch: ``recommend.encode``
(raw ids to rows), ``recommend.masks`` (the shared and watched masks),
``scan.call`` (ops/topk.host_topk) and ``recommend.join`` (the records);
encode and join carry the batch's size as ``ids``.
"""

from __future__ import annotations

import numpy as np
import torch

from anime_recommendations_tpu_torch.ops.scoring import score_topk
from anime_recommendations_tpu_torch.ops.topk import cosine_topk, host_topk
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.utils.profiling import span


def _rows(table: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return table[torch.as_tensor(idx, dtype=torch.long, device=table.device)]


def _kept(vals: np.ndarray, idx: np.ndarray, watched_masks: list, n: int) -> np.ndarray:
    """Each row's kept scan rows (live, and not watched by its user) over the
    narrowest prefix of the columns, doubling from ``2 n``, in which every
    row keeps ``n`` rows or that is the whole width: each row's first ``n``
    kept rows lie inside it, at a cost set by ``n`` and not by ``k``."""
    width = min(2 * n, vals.shape[1])
    while True:
        cols = np.clip(idx[:, :width], 0, None)
        watched = np.array([m[c] for m, c in zip(watched_masks, cols)], bool).reshape(cols.shape)
        keep = (vals[:, :width] > -1e29) & ~watched
        if width == vals.shape[1] or (keep.sum(1) >= n).all():
            return keep
        width = min(2 * width, vals.shape[1])


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
        _rows(ctx.anime_norm, q_idx),
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
    afterwards, so the scan asks for ``n_recs + max watched`` candidates.
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
        watched_masks = [ctx.watched_mask(int(u)) for u in user_ids]
        buffer = max(int(m.sum()) for m in watched_masks) if watched_masks else 0
    k = min(n_recs + buffer, ctx.vocab.n_anime)

    vals, idx = host_topk(
        score_topk,
        ctx.anime_table(),
        _rows(ctx.user_norm, user_idx),
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
        keep = _kept(vals, idx, watched_masks, n_recs * ctx.catalog_repeats)
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
        _rows(ctx.user_norm, q_idx),
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
