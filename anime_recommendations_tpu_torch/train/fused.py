"""Fused-Adam training step: dense Adam through one K1 kernel pass per table.

Counterpart of anime_recommendations_tpu/train/fused.py. The math is the
dense path's (train/trainer.py train_step): every table row gets the moment
decay and the full-table L2 gradient 2*l2*W each step, and the reported loss
includes the L2 term's value. What changes is the memory plan: gradients
are taken with respect to the GATHERED rows only (the dense table gradient
never exists), and ops/fused_adam.sparse_adam_update scatters them, decays,
updates the moments and the table, and returns the pre-update sum of
squares, in one read and write of (W, mu, nu). The four head scalars take
ordinary Adam with the shared step count.

The moments' dtype in the state selects f32 or bf16 storage
(``fused_adam_bf16m``, train/trainer.cast_table_moments).
"""

from __future__ import annotations

import torch

from anime_recommendations_tpu_torch.models.two_tower import HEAD_KEYS
from anime_recommendations_tpu_torch.ops.fused_adam import sparse_adam_update
from anime_recommendations_tpu_torch.train.lazy import _data_loss, _scalar_adam
from anime_recommendations_tpu_torch.train.trainer import (
    B1,
    B2,
    KERAS_ADAM_EPS,
    TrainState,
    _keep_bn,
    bias_corrections,
)


def _fused_step(state: TrainState, u_rows, a_rows, users, anime, ratings, weights,
                lr: float, l2_reg_factor: float, next_users=None, next_anime=None):
    """The step on gathered rows. With next ids, each table's update also
    returns w'[next ids] (K5); the result then ends in those two rows."""
    model, adam = state.model, state.adam
    u_rows = u_rows.detach().requires_grad_()
    a_rows = a_rows.detach().requires_grad_()
    head_params = tuple(p.detach().requires_grad_() for p in model.head_params())
    data_loss, (mse, new_bn) = _data_loss(u_rows, a_rows, head_params,
                                          model.bn_state(), ratings, weights)
    d_u, d_a, *d_head = torch.autograd.grad(data_loss, (u_rows, a_rows, *head_params))
    t = adam.count + 1
    with torch.no_grad():
        sumsq, next_rows = [], []
        for k, ids, grad, nxt in (("user_emb", users, d_u, next_users),
                                  ("anime_emb", anime, d_a, next_anime)):
            _, _, _, s, *rows = sparse_adam_update(
                getattr(model, k).detach(), adam.mu[k], adam.nu[k], ids, grad, t, lr,
                l2=l2_reg_factor, b1=B1, b2=B2, eps=KERAS_ADAM_EPS, next_ids=nxt)
            sumsq.append(s)
            next_rows += rows
        loss = data_loss.detach() + l2_reg_factor * (sumsq[0] + sumsq[1])
        bc1, bc2 = bias_corrections(t)
        for k, g in zip(HEAD_KEYS, d_head):
            p, adam.mu[k], adam.nu[k] = _scalar_adam(
                getattr(model, k), adam.mu[k], adam.nu[k], g, bc1, bc2, lr)
            getattr(model, k).copy_(p)
        _keep_bn(model, new_bn)
    adam.count = t
    return (state, loss, mse.detach(), *next_rows)


def fused_train_step(
    state: TrainState,
    users: torch.Tensor,
    anime: torch.Tensor,
    ratings: torch.Tensor,
    weights: torch.Tensor,
    lr: float,
    l2_reg_factor: float,
) -> tuple[TrainState, torch.Tensor, torch.Tensor]:
    """One fused dense-Adam step. Returns (state, batch_loss, batch_mse).

    ``batch_loss`` includes the full-table L2 regularizer's value at the
    pre-update parameters, as the dense path's history ``loss`` does."""
    model = state.model
    u_rows = model.user_emb.detach()[users]
    a_rows = model.anime_emb.detach()[anime]
    return _fused_step(state, u_rows, a_rows, users, anime, ratings, weights, lr,
                       l2_reg_factor)


def fused_train_step_pipelined(
    state: TrainState,
    u_rows: torch.Tensor,       # [B, D] user rows of THIS batch, gathered last step
    a_rows: torch.Tensor,       # [B, D] anime rows of THIS batch
    users: torch.Tensor,
    anime: torch.Tensor,
    ratings: torch.Tensor,
    weights: torch.Tensor,
    next_users: torch.Tensor,   # [B] ids of the NEXT batch
    next_anime: torch.Tensor,
    lr: float,
    l2_reg_factor: float,
    kernel_gather: bool = False,
) -> tuple[TrainState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """fused_train_step on rows gathered at the end of the previous step,
    returning the rows the next step consumes, gathered from the updated
    tables: the JAX device loop's software pipeline. The result is the same
    as fused_train_step's.

    ``kernel_gather=True`` gathers those rows inside the update kernel (K5,
    ``sparse_adam_update(next_ids=...)``), out of each table block it has
    just updated; False gathers them with torch indexing after the update.
    Both give copies, never views of the tables, and equal rows bit for bit.
    Returns (state, loss, mse, next_u_rows, next_a_rows)."""
    if kernel_gather:
        return _fused_step(state, u_rows, a_rows, users, anime, ratings, weights, lr,
                           l2_reg_factor, next_users, next_anime)
    state, loss, mse = _fused_step(state, u_rows, a_rows, users, anime, ratings,
                                   weights, lr, l2_reg_factor)
    model = state.model
    return (state, loss, mse, model.user_emb.detach()[next_users],
            model.anime_emb.detach()[next_anime])
