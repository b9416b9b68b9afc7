"""Helpers of the JAX package's train/lazy.py that the fused step needs.

Counterpart of ``_scalar_adam`` and ``_data_loss`` in
anime_recommendations_tpu/train/lazy.py. LazyAdam itself (``lazy_row_adam``,
``lazy_train_step``) is not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch

from anime_recommendations_tpu_torch.models.two_tower import (
    BNState,
    bce,
    cosine_merge,
    head,
)
from anime_recommendations_tpu_torch.train.trainer import B1, B2, KERAS_ADAM_EPS


def _scalar_adam(p, mu, nu, g, bc1, bc2, lr, eps=KERAS_ADAM_EPS):
    """Adam on one head scalar. Returns (p', mu', nu') as new tensors."""
    mu_new = B1 * mu + (1.0 - B1) * g
    nu_new = B2 * nu + (1.0 - B2) * (g * g)
    p_new = p - lr * (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
    return p_new, mu_new, nu_new


def _data_loss(u_rows: torch.Tensor, a_rows: torch.Tensor, head_params,
               bn_state: BNState, ratings: torch.Tensor, weights: torch.Tensor):
    """Weighted-mean BCE of gathered rows through the train-mode head (no L2
    term). Returns (loss, (mse, new_bn_state))."""
    cos = cosine_merge(u_rows, a_rows)
    pred, new_bn = head(head_params, cos, bn_state, train=True, weights=weights)
    denom = torch.clamp_min(torch.sum(weights), 1.0)
    loss = torch.sum(bce(pred, ratings) * weights) / denom
    mse = torch.sum(torch.square(pred - ratings) * weights) / denom
    return loss, (mse, new_bn)
