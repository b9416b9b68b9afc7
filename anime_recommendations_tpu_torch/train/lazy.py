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

Duplicate ids in a batch: the batch is sorted stably by id and each run of
equal ids sums its gradient rows and takes one update of its row. Every
shape is fixed by the batch size, as in JAX, whose segment sums send the
duplicates out of bounds (``mode="drop"``), so no step needs the number of
unique ids on the host and a CUDA graph can capture it. The update is
ops/lazy_adam.lazy_adam_, one call for both tables: on a card one stable
sort of both tables' ids and one kernel launch (csrc/lazy_adam.cu), which
sums each run in a fixed order and writes each row once; elsewhere its
plain version, a torch chain per table (``index_add_`` of the runs into a
[B, D] buffer, each sorted position computing its run's update, and
``index_copy_`` writing them all: the positions of one run write the same
bits; on a card its atomics would sum in an order that varies from run to
run). The JAX package sorts unstably and segment-sums, so a duplicated
row's sum may differ from it in its last f32 bits.

The JAX package has no Pallas kernel here. The four head scalars take dense
Adam (ops/dense_adam.py: one kernel launch on a card). On a card
``lazy_train_step`` is one CUDA graph replay per call from a signature's
third call on (train/step_graph.py); ``lazy_step`` is its eager body. The
step's first update from a fresh state with l2 = 0 equals dense Adam's on
the touched rows (tests/test_torch_lazy.py).
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
from anime_recommendations_tpu_torch.ops.dense_adam import dense_adam_
from anime_recommendations_tpu_torch.ops.lazy_adam import LazyTable, lazy_adam_
from anime_recommendations_tpu_torch.train.trainer import (
    B1,
    B2,
    KERAS_ADAM_EPS,
    TrainState,
    _keep_bn,
    run_step,
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
    scal: torch.Tensor,     # [4] step row on w's device (trainer.step_row)
    l2: float,
    b1: float = B1,
    b2: float = B2,
    eps: float = KERAS_ADAM_EPS,
    keep: torch.Tensor | None = None,
) -> _RowUpdate:
    """One lazy-Adam table update, in place. Touches only rows in ``ids``;
    returns the three (updated) tables. ``scal`` holds the step's lr, bc1
    and bc2 (ops/fused_adam.scalar_rows, made with these b1 and b2), read as
    0-dim device tensors. Every shape is fixed by B (module docstring).
    ``keep`` ([B] bool): positions marked False add nothing to their run's
    sum, and a run none of whose positions is kept writes its row back
    unchanged, so they drop out as if absent (JAX's ``mode="drop"``).
    ops/lazy_adam.lazy_adam_ with one table: one kernel launch on a card."""
    lazy_adam_([LazyTable(w, mu, nu, ids, g_rows, keep)], scal, l2, b1, b2, eps)
    return _RowUpdate(w, mu, nu)


def _head_adam(state: TrainState, d_head, scal: torch.Tensor) -> None:
    """Dense Adam on the four head scalars with the step row's scalars
    (ops/dense_adam.py: one kernel launch on a card), in place: a captured
    CUDA graph updates the same memory at every replay."""
    model, adam = state.model, state.adam
    dense_adam_([getattr(model, k) for k in HEAD_KEYS], list(d_head),
                [adam.mu[k] for k in HEAD_KEYS], [adam.nu[k] for k in HEAD_KEYS], scal)


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
    users,
    anime,
    ratings,
    weights,
    lr: float,
    l2_reg_factor: float,
) -> tuple[TrainState, torch.Tensor, torch.Tensor]:
    """One lazy-Adam step (the batch columns tensors or numpy arrays).
    Returns (state, batch_data_loss, batch_mse).

    Gradients are taken with respect to the GATHERED rows (no dense table
    gradient exists); both tables update through one lazy_adam_ call, the
    four head scalars through ordinary Adam with the shared step count. On
    a card a replay of the step's graph (train/step_graph.py)."""

    def body(st, users, anime, ratings, weights, scal):
        return lazy_step(st, users, anime, ratings, weights, scal, l2_reg_factor)

    loss, mse = run_step(("lazy", float(l2_reg_factor)), body, state, lr, users=users,
                         anime=anime, ratings=ratings, weights=weights)
    return state, loss, mse


def lazy_step(state: TrainState, users, anime, ratings, weights, scal: torch.Tensor,
              l2_reg_factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """lazy_train_step's work with the step's scalars read from ``scal``
    (trainer.dense_step's contract: no host sync; the caller advances the
    count). Returns (batch_data_loss, batch_mse)."""
    model, adam = state.model, state.adam
    u_rows = model.user_emb.detach()[users].requires_grad_()
    a_rows = model.anime_emb.detach()[anime].requires_grad_()
    head_params = tuple(p.detach().requires_grad_() for p in model.head_params())
    loss, (mse, new_bn) = _data_loss(u_rows, a_rows, head_params, model.bn_state(),
                                     ratings, weights)
    d_u, d_a, *d_head = torch.autograd.grad(loss, (u_rows, a_rows, *head_params))
    with torch.no_grad():
        lazy_adam_([LazyTable(getattr(model, k).detach(), adam.mu[k], adam.nu[k], ids, grad)
                    for k, ids, grad in (("user_emb", users, d_u), ("anime_emb", anime, d_a))],
                   scal, l2_reg_factor)
        _head_adam(state, d_head, scal)
        _keep_bn(model, new_bn)
    return loss.detach(), mse.detach()
