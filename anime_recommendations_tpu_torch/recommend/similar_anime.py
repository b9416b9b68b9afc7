"""Similar-anime retrieval.

Counterpart of anime_recommendations_tpu/recommend/similar_anime.py: one
masked top-k scan with the type/genre/self filters as row masks, then one
vectorized metadata join.

Output schema: Name, Similarity, Genres, Sypnopsis, Episodes, Japanese name,
Studios, Premiered, Score, Type, Source, Rating — sorted by Similarity
descending.

Spans (utils/profiling.span) as in recommend/batch.py: recommend.encode,
recommend.masks, scan.call and recommend.join.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from anime_recommendations_tpu_torch.utils.text import clean_name
from anime_recommendations_tpu_torch.ops.topk import cosine_topk, host_topk
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.utils.profiling import span

OUTPUT_COLUMNS = [
    "Name", "Similarity", "Genres", "Sypnopsis", "Episodes", "Japanese name",
    "Studios", "Premiered", "Score", "Type", "Source", "Rating",
]


def similar_anime(
    ctx: RecContext,
    name: str,
    count: int = 10,
    types: list[str] | None = None,
    genres: list | None = None,
) -> tuple[pd.DataFrame, str, str]:
    """Top-``count`` anime most similar to ``name`` by embedding cosine.

    ``types``/``genres`` of None disable that filter.
    Returns (frame, csv_filename, cleaned_name).
    """
    translated = clean_name(name)
    filename = translated + ".csv"

    with span("recommend.encode"):
        anime_id = ctx.catalog.resolve_query(name)
        query_index = ctx.anime_index(anime_id)

    with span("recommend.masks"):
        mask = ctx.in_catalog_mask()
        if types is not None:
            mask &= ctx.type_mask(types)
        if genres is not None:
            mask &= ctx.genre_mask(genres)

    vals, idx = host_topk(
        cosine_topk,
        ctx.anime_table(),
        ctx.anime_vectors([query_index]),
        k=min(count, ctx.vocab.n_anime),
        mask=mask,
        exclude=np.asarray([query_index]),
        graphs=ctx.scan_graphs,
        **ctx.topk_kwargs,
    )
    with span("recommend.join"):
        vals, idx = vals[0], idx[0]
        keep = vals > -1e29  # fewer valid rows than k -> trim sentinels
        vals, idx = vals[keep], idx[keep]

        anime_ids = ctx.vocab.anime_ids[idx]
        frame = enrich_anime_rows(
            ctx, anime_ids, extra={"Similarity": vals}, columns=OUTPUT_COLUMNS
        )
    return frame, filename, translated


_DEFAULT_ENRICH_COLUMNS = [
    "anime_id", "Name", "Genres", "Sypnopsis", "Episodes", "Japanese name",
    "Studios", "Premiered", "Score", "Type", "Source", "Rating",
]
_COLUMN_SOURCES = {"Japanese name": "japanese_name"}


def enrich_anime_rows(
    ctx: RecContext,
    anime_ids: np.ndarray,
    extra: dict[str, np.ndarray],
    columns: list[str] | None = None,
) -> pd.DataFrame:
    """Vectorized metadata + synopsis join: k gathers from the catalog's
    cached column arrays. ``extra`` columns are per-input-id and aligned to
    the produced rows (ids absent from the catalog drop their extra values
    too). ``columns`` fixes the output column order (extra names
    included)."""
    pos, src = ctx.catalog.positions_for_ids_ordered(anime_ids)
    cols = ctx.catalog.column_arrays
    aid = cols["anime_id"][pos]
    if columns is None:
        columns = _DEFAULT_ENRICH_COLUMNS + list(extra)
    data = {}
    for c in columns:
        if c in extra:
            data[c] = np.asarray(extra[c])[src]
        elif c == "Sypnopsis":
            data[c] = [ctx.catalog.synopsis_of(int(a)) for a in aid]
        elif c == "anime_id":
            data[c] = aid
        else:
            data[c] = cols[_COLUMN_SOURCES.get(c, c)][pos]
    return pd.DataFrame(data)
