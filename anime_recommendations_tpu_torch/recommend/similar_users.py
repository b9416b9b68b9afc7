"""Similar-users retrieval.

Counterpart of anime_recommendations_tpu/recommend/similar_users.py: one
cosine scan over the user table with the query user excluded inside the
scan, then each similar user's favorite anime.

Output schema: similar_users, similarity, favorite_animes — sorted by
similarity descending.

Spans (utils/profiling.span) as in recommend/batch.py: recommend.encode,
scan.call and recommend.join.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from anime_recommendations_tpu_torch.ops.topk import cosine_topk, host_topk
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.utils.profiling import span

OUTPUT_COLUMNS = ["similar_users", "similarity", "favorite_animes"]


def similar_users(
    ctx: RecContext,
    user_id: int,
    n_users: int = 10,
    num_faves: int = 2,
    TV_only: bool = True,
) -> tuple[pd.DataFrame, str, int]:
    """Top-``n_users`` most similar users plus their favorite anime.

    Returns (frame, csv_filename, user_id).
    """
    filename = f"User_{user_id}.csv"
    with span("recommend.encode"):
        query_index = ctx.user_index(user_id)

    vals, idx = host_topk(
        cosine_topk,
        ctx.user_table(),
        ctx.user_vectors([query_index]),
        k=min(n_users, ctx.vocab.n_users),
        exclude=np.asarray([query_index]),
        graphs=ctx.scan_graphs,
        **ctx.topk_kwargs,
    )
    with span("recommend.join"):
        vals, idx = vals[0], idx[0]
        keep = vals > -1e29
        vals, idx = vals[keep], idx[keep]

        similar_ids = ctx.vocab.user_ids[idx]
        frame = pd.DataFrame(
            {
                "similar_users": similar_ids,
                "similarity": vals,
                "favorite_animes": [
                    get_fave_anime(ctx, int(uid), num_faves, TV_only)
                    for uid in similar_ids
                ],
            }
        )
    return frame.reset_index(drop=True), filename, user_id


def get_fave_anime(
    ctx: RecContext, user_id: int, num_faves: int, TV_only: bool
) -> str:
    """A user's favorite anime as a bracket-stripped list string.

    Rules: take the max-rated anime; when watched_episodes data exists, keep
    only rows with the highest percent-of-episodes-watched; if TV_only,
    order by episode count descending; return the first ``num_faves`` names
    via str(list)[1:-1]. Anime absent from the catalog are skipped.
    """
    r, aid, _ = ctx.user_rating_arrays(user_id)
    if r.size == 0:
        return ""
    at_max = r == r.max()
    fave_ids = aid[at_max]
    pos, src = ctx.catalog.positions_for_ids_ordered(fave_ids)
    if len(pos) == 0:
        return ""
    names = ctx.catalog.column_arrays["Name"][pos]
    episodes = ctx.catalog.episodes_numeric[pos]

    watched = ctx.user_watched_episodes(user_id)
    if watched is not None:
        percent = watched[at_max][src] / episodes
        pmax = np.nanmax(percent) if np.any(~np.isnan(percent)) else np.nan
        if not np.isnan(pmax):
            keep = percent == pmax
            names, episodes = names[keep], episodes[keep]
    if TV_only:
        names = names[_pandas_desc_order(episodes)]
    all_faves = list(names)
    return str(all_faves[:num_faves])[1:-1]


def _pandas_desc_order(values: np.ndarray) -> np.ndarray:
    """Index order of pandas sort_values(ascending=False, kind='quicksort',
    na_position='last') — the reference's episode-count tie-break sort —
    replicated step for step (reverse, ascending quicksort, reverse, NaNs
    appended)."""
    idx = np.arange(len(values))
    nan = np.isnan(values)
    non_nans = values[~nan][::-1]
    non_nan_idx = idx[~nan][::-1]
    order = non_nan_idx[non_nans.argsort(kind="quicksort")][::-1]
    return np.concatenate([order, idx[nan]])
