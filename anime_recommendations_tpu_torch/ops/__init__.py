"""ops of the PyTorch port (see the package docstring)."""

from anime_recommendations_tpu_torch.ops.normalize import l2_normalize_rows
from anime_recommendations_tpu_torch.ops.scoring import score_all_items, score_topk
from anime_recommendations_tpu_torch.ops.topk import cosine_topk, masked_topk

__all__ = [
    "cosine_topk",
    "masked_topk",
    "l2_normalize_rows",
    "score_all_items",
    "score_topk",
]
