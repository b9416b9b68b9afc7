"""Device half of the retrieval context: what every scan reads.

The normalized tables in logical vocab order (for reading query rows), the
folded eval-mode head, and the scan copies of the tables: in a fixed random
row order (ShuffledTable, ops/topk.py), for an int8 context quantized after
the shuffle (ops/quantized.py), or IVF indexes over the normalized tables
(ops/ivf.py). Imports no pandas: recommend/context.py adds the host frames.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from anime_recommendations_tpu_torch.models.two_tower import TF_L2_NORM_EPS, TwoTower
from anime_recommendations_tpu_torch.ops.ivf import IVFIndex, build_ivf
from anime_recommendations_tpu_torch.ops.normalize import l2_normalize_rows
from anime_recommendations_tpu_torch.ops.quantized import QuantizedTable, quantize_rows
from anime_recommendations_tpu_torch.ops.scoring import head_affine
from anime_recommendations_tpu_torch.ops.topk import ShuffledTable, shuffle_rows

_DTYPES = {
    None: torch.float32, "f32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "i8": torch.int8,
}
ANIME_SHUFFLE_SEED, USER_SHUFFLE_SEED = 11, 13


@dataclass(frozen=True)
class RetrievalTables:
    anime_norm: torch.Tensor         # [n_anime, D] L2-normalized (f32 for int8)
    user_norm: torch.Tensor          # [n_users, D]
    head: torch.Tensor               # [2] f32 (alpha, beta) folded eval-mode head
    anime_scan: ShuffledTable | IVFIndex   # .table: rows, or a QuantizedTable for int8
    user_scan: ShuffledTable | IVFIndex
    anime_qt: QuantizedTable | None = None   # the int8 scan tables (None: float)
    user_qt: QuantizedTable | None = None


def retrieval_dtype_of(retrieval_dtype) -> torch.dtype:
    """f32 (exact scans), bf16 (half the scan traffic) or int8 (a quarter,
    candidates rescored in f32)."""
    try:
        return _DTYPES[retrieval_dtype]
    except KeyError:
        raise ValueError(
            f"unknown retrieval_dtype {retrieval_dtype!r}: choose 'f32', 'bf16' or 'int8'"
        ) from None


@torch.no_grad()
def build_tables(model: TwoTower, *, device, retrieval_dtype=None,
                 ann: str = "off") -> RetrievalTables:
    """Normalize both tables in the retrieval dtype (one pass each through
    ops/normalize.l2_normalize_rows, with two_tower's eps), fold the head,
    and store the scan copies in a fixed random row order, all on
    ``device``. The shuffle keeps trained tables, which put hot, mutually
    similar rows at adjacent vocab ids, from crowding one 512-row group. An
    int8 context keeps f32 rows and quantizes the shuffled scan copies, as
    the JAX RecContext does.

    ``ann="ivf"`` builds IVF indexes over the normalized tables instead
    (anime with seed 11, users with seed 13; int8 storage for an int8
    context): IVF gathers rows by id, so it takes no shuffled copy."""
    if ann not in ("off", "ivf"):
        raise ValueError(f"ann must be 'off' or 'ivf', got {ann!r}")
    dtype = retrieval_dtype_of(retrieval_dtype)
    norm_dtype = torch.float32 if dtype == torch.int8 else dtype
    anime_norm, user_norm = (
        l2_normalize_rows(emb.detach().to(device=device, dtype=torch.float32).contiguous(),
                          eps=TF_L2_NORM_EPS, out_dtype=norm_dtype)
        for emb in (model.anime_emb, model.user_emb)
    )
    head = head_affine(model).to(device=device, dtype=torch.float32)
    if ann == "ivf":
        storage = "int8" if dtype == torch.int8 else "f32"
        return RetrievalTables(
            anime_norm=anime_norm, user_norm=user_norm, head=head,
            anime_scan=build_ivf(anime_norm, seed=ANIME_SHUFFLE_SEED, storage=storage),
            user_scan=build_ivf(user_norm, seed=USER_SHUFFLE_SEED, storage=storage),
        )
    anime_scan = shuffle_rows(anime_norm, seed=ANIME_SHUFFLE_SEED)
    user_scan = shuffle_rows(user_norm, seed=USER_SHUFFLE_SEED)
    anime_qt = user_qt = None
    if dtype == torch.int8:
        anime_qt, user_qt = quantize_rows(anime_scan.table), quantize_rows(user_scan.table)
        anime_scan, user_scan = anime_scan._replace(table=anime_qt), user_scan._replace(table=user_qt)
    return RetrievalTables(
        anime_norm=anime_norm,
        user_norm=user_norm,
        head=head,
        anime_scan=anime_scan,
        user_scan=user_scan,
        anime_qt=anime_qt,
        user_qt=user_qt,
    )
