"""Batched retrieval entry points.

Counterpart of anime_recommendations_tpu/recommend/batch.py: many queries
ride one scan of the table, then one vectorized metadata join.

Spans (utils/profiling.span), each around a whole loop: ``recommend.encode``
(raw ids to rows), ``recommend.masks`` (the shared and watched masks),
``scan.call`` (ops/topk.host_topk) and ``recommend.join`` (the records).
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
    with span("recommend.encode"):
        ids = [ctx.catalog.resolve_query(n) for n in names]
        q_idx = np.asarray([ctx.anime_index(a) for a in ids], np.int64)

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
    out = []
    with span("recommend.join"):
        for row, name in enumerate(names):
            keep = vals[row] > -1e29
            anime_ids = ctx.vocab.anime_ids[idx[row][keep]]
            rows = ctx.catalog.rows_for_ids(anime_ids)
            out.append(
                {
                    "query": name,
                    "anime_ids": rows["anime_id"].tolist(),
                    "names": rows["Name"].tolist(),
                    "similarities": vals[row][keep][: len(rows)].tolist(),
                }
            )
    return out


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
    with span("recommend.encode"):
        user_idx = np.asarray([ctx.user_index(u) for u in user_ids], np.int64)

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
    out = []
    with span("recommend.join"):
        for row, uid in enumerate(user_ids):
            watched = watched_masks[row]
            keep = (vals[row] > -1e29) & ~watched[np.clip(idx[row], 0, None)]
            sel = idx[row][keep][:n_recs]
            anime_ids = ctx.vocab.anime_ids[sel]
            rows = ctx.catalog.rows_for_ids(anime_ids)
            out.append(
                {
                    "user_id": int(uid),
                    "anime_ids": rows["anime_id"].tolist(),
                    "names": rows["Name"].tolist(),
                    "predictions": vals[row][keep][: len(rows)].tolist(),
                }
            )
    return out


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

    with span("recommend.encode"):
        q_idx = np.asarray([ctx.user_index(int(u)) for u in user_ids], np.int64)
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
    with span("recommend.join"):
        for row, uid in enumerate(user_ids):
            keep = vals[row] > -1e29
            sim_ids = ctx.vocab.user_ids[idx[row][keep]]
            rec = {
                "query": int(uid),
                "similar_users": [int(s) for s in sim_ids],
                "similarities": vals[row][keep].tolist(),
            }
            if include_faves:
                rec["favorite_animes"] = [
                    get_fave_anime(ctx, int(s), num_faves, TV_only)
                    for s in sim_ids
                ]
            out.append(rec)
    return out
