"""Device half of the retrieval context: what every scan reads.

The normalized tables in logical vocab order (for reading query rows), the
folded eval-mode head, and the scan copies of the tables in a fixed random
row order (ShuffledTable, ops/topk.py). Imports no pandas:
recommend/context.py adds the host frames.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from anime_recommendations_tpu_torch.models.two_tower import TwoTower, normalized_tables
from anime_recommendations_tpu_torch.ops.scoring import head_affine
from anime_recommendations_tpu_torch.ops.topk import ShuffledTable, shuffle_rows

_DTYPES = {
    None: torch.float32, "f32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
}
ANIME_SHUFFLE_SEED, USER_SHUFFLE_SEED = 11, 13


@dataclass(frozen=True)
class RetrievalTables:
    anime_norm: torch.Tensor         # [n_anime, D] L2-normalized, retrieval dtype
    user_norm: torch.Tensor          # [n_users, D]
    head: torch.Tensor               # [2] f32 (alpha, beta) folded eval-mode head
    anime_scan: ShuffledTable
    user_scan: ShuffledTable


def retrieval_dtype_of(retrieval_dtype) -> torch.dtype:
    """f32 (exact scans) or bf16 (half the scan traffic); int8 is not ported."""
    if retrieval_dtype in ("int8", "i8"):
        raise NotImplementedError(
            "int8 retrieval (QuantizedTable) is not ported yet: ROADMAP.md Queue 2 K2q"
        )
    try:
        return _DTYPES[retrieval_dtype]
    except KeyError:
        raise ValueError(
            f"unknown retrieval_dtype {retrieval_dtype!r}: choose 'f32' or 'bf16'"
        ) from None


@torch.no_grad()
def build_tables(model: TwoTower, *, device, retrieval_dtype=None) -> RetrievalTables:
    """Normalize both tables, cast them to the retrieval dtype, fold the
    head, and store the scan copies in a fixed random row order, all on
    ``device``. The shuffle keeps trained tables, which put hot, mutually
    similar rows at adjacent vocab ids, from crowding one 512-row group."""
    dtype = retrieval_dtype_of(retrieval_dtype)
    anime_norm, user_norm = (
        t.to(device=device, dtype=dtype).contiguous() for t in normalized_tables(model)
    )
    return RetrievalTables(
        anime_norm=anime_norm,
        user_norm=user_norm,
        head=head_affine(model).to(device=device, dtype=torch.float32),
        anime_scan=shuffle_rows(anime_norm, seed=ANIME_SHUFFLE_SEED),
        user_scan=shuffle_rows(user_norm, seed=USER_SHUFFLE_SEED),
    )
