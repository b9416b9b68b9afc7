"""Batched all-anime rating prediction (model_recs hot path).

Counterpart of anime_recommendations_tpu/ops/scoring.py. The trained head
is an affine map of the cosine followed by another (eval-mode BatchNorm),
so it folds into sigmoid(alpha * cos + beta) with

    alpha = gamma * w / sqrt(moving_var + eps)
    beta  = gamma * (b - moving_mean) / sqrt(moving_var + eps) + bn_beta

which stage 1 of the top-k applies inside its kernel.
"""

from __future__ import annotations

import torch

from anime_recommendations_tpu_torch.models.two_tower import KERAS_BN_EPS, TwoTower
from anime_recommendations_tpu_torch.ops.topk import _dispatch_topk


@torch.no_grad()
def head_affine(model: TwoTower) -> torch.Tensor:
    """Fold Dense(1) + eval-mode BatchNorm into (alpha, beta), [2] f32."""
    inv = torch.rsqrt(model.moving_var + KERAS_BN_EPS)
    alpha = model.bn_gamma * model.dense_w * inv
    beta = model.bn_gamma * (model.dense_b - model.moving_mean) * inv + model.bn_beta
    return torch.stack([alpha, beta])


@torch.no_grad()
def score_all_items(model: TwoTower, user_index: int) -> torch.Tensor:
    """Predicted rating of every anime for one user, [n_anime] (dense path,
    for parity tests and full-score exports)."""
    u = model.user_emb[user_index]
    u = u / torch.linalg.norm(u)
    a = model.anime_emb / torch.linalg.norm(model.anime_emb, dim=1, keepdim=True)
    alpha, beta = head_affine(model)
    return torch.sigmoid(alpha * (a @ u) + beta)


def score_topk(
    anime_table_normalized,               # [N, D] rows, QuantizedTable, ShuffledTable, IVFIndex
    user_rows_normalized: torch.Tensor,   # [Qn, D] L2-normalized user rows
    head: torch.Tensor,                   # [2] (alpha, beta) from head_affine
    k: int,
    mask=None,                            # [N] True keeps (e.g. not watched)
    exclude=None,
    *,
    exact_scan: bool = False,
    top_r: int | None = None,
    m: int | None = None,
    probes: int | None = None,
    graphs=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused predict-all + mask + top-k: (ratings [Qn, k], anime rows). The
    keywords are ops/topk._dispatch_topk's: on a CUDA table one request is
    one replay of its scan graph, the head a device tensor among its
    inputs."""
    if user_rows_normalized.dim() == 1:
        user_rows_normalized = user_rows_normalized[None, :]
    return _dispatch_topk(anime_table_normalized, user_rows_normalized, mask,
                          exclude, head, k=k, exact_scan=exact_scan, top_r=top_r, m=m,
                          probes=probes, graphs=graphs)
