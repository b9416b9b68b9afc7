"""Model-based recommendations (rating prediction over unwatched anime).

Counterpart of anime_recommendations_tpu/recommend/model_recs.py: the
unwatched set is a row mask over the anime table and predict-all + mask +
top-n is one scan (ops/scoring.score_topk) with the Dense + BatchNorm +
sigmoid head folded into the stage-1 kernel.

Output schema: Name, Prediction, Genres, Source, anime_id, Sypnopsis,
Episodes, Japanese name, Studios, Premiered, Score, Type.

Spans (utils/profiling.span) as in recommend/batch.py: recommend.encode,
recommend.masks, scan.call and recommend.join.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from anime_recommendations_tpu_torch.ops.scoring import score_topk
from anime_recommendations_tpu_torch.ops.topk import host_topk
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.utils.profiling import span

OUTPUT_COLUMNS = [
    "Name", "Prediction", "Genres", "Source", "anime_id", "Sypnopsis",
    "Episodes", "Japanese name", "Studios", "Premiered", "Score", "Type",
]


def model_recs(
    ctx: RecContext,
    user_id: int,
    n_recs: int = 10,
    types: list[str] | None = None,
    genres: list | None = None,
    min_score: float | None = None,
    max_score: float | None = None,
) -> tuple[pd.DataFrame, str]:
    """Top-``n_recs`` unwatched anime by predicted rating for ``user_id``.

    ``min_score``/``max_score`` bound the catalog Score column.
    Returns (frame, csv_filename).
    """
    filename = f"User_ID_{user_id}_model_recs.csv"
    with span("recommend.encode"):
        user_index = ctx.user_index(user_id)

    with span("recommend.masks"):
        mask = ctx.in_catalog_mask() & ~ctx.watched_mask(user_id)
        if types is not None:
            mask &= ctx.type_mask(types)
        if genres is not None:
            mask &= ctx.genre_mask(genres)
        if min_score is not None or max_score is not None:
            score = pd.to_numeric(
                ctx.vocab_meta()["Score"], errors="coerce"
            ).to_numpy(np.float64)
            if min_score is not None:
                mask &= score >= float(min_score)
            if max_score is not None:
                mask &= score <= float(max_score)

    vals, idx = host_topk(
        score_topk,
        ctx.anime_table(),
        ctx.user_vectors([user_index]),
        ctx.head,
        k=min(n_recs, ctx.vocab.n_anime),
        mask=mask,
        graphs=ctx.scan_graphs,
        **ctx.topk_kwargs,
    )
    with span("recommend.join"):
        vals, idx = vals[0], idx[0]
        keep = vals > -1e29
        vals, idx = vals[keep], idx[keep]

        anime_ids = ctx.vocab.anime_ids[idx]
        pos, src = ctx.catalog.positions_for_ids_ordered(anime_ids)
        cols = ctx.catalog.column_arrays
        aid = cols["anime_id"][pos]
        frame = pd.DataFrame(
            {
                "Name": cols["Name"][pos],
                "Prediction": vals[src],
                "Genres": cols["Genres"][pos],
                "Source": cols["Source"][pos],
                "anime_id": aid,
                "Sypnopsis": [ctx.catalog.synopsis_of(int(a)) for a in aid],
                "Episodes": cols["Episodes"][pos],
                "Japanese name": cols["japanese_name"][pos],
                "Studios": cols["Studios"][pos],
                "Premiered": cols["Premiered"][pos],
                "Score": cols["Score"][pos],
                "Type": cols["Type"][pos],
            }
        )
    return frame[OUTPUT_COLUMNS].reset_index(drop=True), filename
