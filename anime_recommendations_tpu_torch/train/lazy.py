"""LazyAdam training step: row-sparse Adam for the embedding tables.

Counterpart of anime_recommendations_tpu/train/lazy.py. The dense path
(train/trainer.py, train/fused.py) keeps Keras semantics: the full-table L2
regularizer makes every gradient dense, so each step reads and writes W, mu
and nu of both tables. LazyAdam (TensorFlow Addons LazyAdam, PyTorch
SparseAdam) applies the Adam moments, the weight update and the L2 decay
only to the rows the batch touches. What differs from the dense path, by
design:
  * untouched rows keep their moments (no decay while unseen);
  * the L2 decay applies once per touch of a row in a step, so the
    effective regularization grows with a row's frequency;
  * the step's loss is the data loss only (the L2 term's value would cost a
    full-table pass); the history's ``loss`` then excludes it while its
    ``val_loss`` (the full eval path) includes it.

Duplicate ids in a batch: the batch is sorted by id, each run of equal ids
has its gradients summed, and one Adam update per unique row is written with
``index_copy_`` on the unique ids (a write with duplicate indices has no
defined winner on CUDA). The JAX package sorts unstably and segment-sums;
this sorts stably and sums with ``index_add_`` (on the card, in atomics'
order), so a duplicated row's sum may differ in its last f32 bits.

These are plain torch ops, on the card as on the CPU: the JAX package has
no Pallas kernel here. The step's first update from a fresh state with
l2 = 0 equals dense Adam's on the touched rows (tests/test_torch_lazy.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from anime_recommendations_tpu_torch.models.two_tower import (
    HEAD_KEYS,
    BNState,
    bce,
    cosine_merge,
    head,
)
from anime_recommendations_tpu_torch.ops.fused_adam import adam_scalars
from anime_recommendations_tpu_torch.train.trainer import (
    B1,
    B2,
    KERAS_ADAM_EPS,
    TrainState,
    _keep_bn,
    bias_corrections,
)


class _RowUpdate(NamedTuple):
    w: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


@torch.no_grad()
def lazy_row_adam(
    w: torch.Tensor,        # [N, D], updated in place
    mu: torch.Tensor,       # [N, D], updated in place
    nu: torch.Tensor,       # [N, D], updated in place
    ids: torch.Tensor,      # [B] int touched row per example
    g_rows: torch.Tensor,   # [B, D] gradient w.r.t. the gathered rows
    t: int,                 # Adam step count AFTER this update
    lr: float,
    l2: float,
    b1: float = B1,
    b2: float = B2,
    eps: float = KERAS_ADAM_EPS,
) -> _RowUpdate:
    """One lazy-Adam table update, in place. Touches only rows in ``ids``;
    returns the three (updated) tables."""
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order].long()
    g_s = g_rows[order]
    is_start = torch.ones_like(ids_s, dtype=torch.bool)
    is_start[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(is_start, 0) - 1                  # [B] run index
    heads = ids_s[is_start]                              # one id per run
    g_tot = torch.zeros(heads.shape[0], w.shape[1], dtype=g_s.dtype,
                        device=g_s.device).index_add_(0, seg, g_s)
    w_rows, mu_rows, nu_rows = w[heads], mu[heads], nu[heads]
    g_tot = g_tot + (2.0 * l2) * w_rows                  # decay once per run
    scal = adam_scalars(t, lr, l2, b1, b2, eps)
    bc1, bc2 = scal.bc1, scal.bc2
    mu_new = b1 * mu_rows + (1.0 - b1) * g_tot
    nu_new = b2 * nu_rows + (1.0 - b2) * (g_tot * g_tot)
    upd = -lr * (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
    w.index_copy_(0, heads, w_rows + upd)
    mu.index_copy_(0, heads, mu_new)
    nu.index_copy_(0, heads, nu_new)
    return _RowUpdate(w, mu, nu)


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


def lazy_train_step(
    state: TrainState,
    users: torch.Tensor,
    anime: torch.Tensor,
    ratings: torch.Tensor,
    weights: torch.Tensor,
    lr: float,
    l2_reg_factor: float,
) -> tuple[TrainState, torch.Tensor, torch.Tensor]:
    """One lazy-Adam step. Returns (state, batch_data_loss, batch_mse).

    Gradients are taken with respect to the GATHERED rows (no dense table
    gradient exists); the tables update through lazy_row_adam, the four head
    scalars through ordinary Adam with the shared step count."""
    model, adam = state.model, state.adam
    u_rows = model.user_emb.detach()[users].requires_grad_()
    a_rows = model.anime_emb.detach()[anime].requires_grad_()
    head_params = tuple(p.detach().requires_grad_() for p in model.head_params())
    loss, (mse, new_bn) = _data_loss(u_rows, a_rows, head_params, model.bn_state(),
                                     ratings, weights)
    d_u, d_a, *d_head = torch.autograd.grad(loss, (u_rows, a_rows, *head_params))
    t = adam.count + 1
    with torch.no_grad():
        for k, ids, grad in (("user_emb", users, d_u), ("anime_emb", anime, d_a)):
            lazy_row_adam(getattr(model, k).detach(), adam.mu[k], adam.nu[k], ids, grad,
                          t, lr, l2_reg_factor)
        bc1, bc2 = bias_corrections(t)
        for k, g in zip(HEAD_KEYS, d_head):
            p, adam.mu[k], adam.nu[k] = _scalar_adam(
                getattr(model, k), adam.mu[k], adam.nu[k], g, bc1, bc2, lr)
            getattr(model, k).copy_(p)
        _keep_bn(model, new_bn)
    adam.count = t
    return state, loss.detach(), mse.detach()
