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

Duplicate ids in a batch: the batch is sorted by id and each run of equal
ids has its gradients summed into a [B, D] buffer, row r holding run r's
sum, with ``index_add_`` over the run numbers. Every shape is fixed by the
batch size, as in JAX, whose segment sums send the duplicates out of bounds
(``mode="drop"``): each sorted position computes its run's update from the
run's sum and the row's old values, so the positions of one run compute the
same bits, and ``index_copy_`` writes them all (a write with duplicate
indices has no defined winner on CUDA; here every writer agrees). No step
needs the number of unique ids on the host, so a CUDA graph can capture it.
The JAX package sorts unstably and segment-sums; this sorts stably and sums
with ``index_add_`` (on the card, in atomics' order, which varies from run
to run; ``index_put_(accumulate=True)`` would sum in a fixed order, but its
serial chain over a hot row's run cost 0.24 ms more a step on an H100 at
full width), so a duplicated row's sum may differ in its last f32 bits.

The row updates are plain torch ops, on the card as on the CPU: the JAX
package has no Pallas kernel here. The four head scalars take dense Adam
(ops/dense_adam.py: one kernel launch on a card). On a card
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
    unchanged, so they drop out as if absent (JAX's ``mode="drop"``)."""
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order].long()
    g_s = g_rows[order]
    if keep is not None:
        keep_s = keep[order]
        g_s = torch.where(keep_s[:, None], g_s, 0.0)
    is_start = torch.ones_like(ids_s, dtype=torch.bool)
    is_start[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(is_start, 0) - 1                  # [B] run of each position
    g_run = torch.zeros_like(g_s).index_add_(0, seg, g_s)  # row r: run r's sum
    w_rows, mu_rows, nu_rows = w[ids_s], mu[ids_s], nu[ids_s]
    g_tot = g_run[seg] + (2.0 * l2) * w_rows             # decay once per run
    lr, bc1, bc2 = scal[0], scal[1], scal[2]
    mu_new = b1 * mu_rows + (1.0 - b1) * g_tot
    nu_new = b2 * nu_rows + (1.0 - b2) * (g_tot * g_tot)
    upd = -lr * (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
    w_new = w_rows + upd
    if keep is not None:
        live = torch.zeros_like(ids_s).index_add_(0, seg, keep_s.long())[seg] > 0
        w_new = torch.where(live[:, None], w_new, w_rows)
        mu_new = torch.where(live[:, None], mu_new, mu_rows)
        nu_new = torch.where(live[:, None], nu_new, nu_rows)
    # The positions of one run write the same bits.
    w.index_copy_(0, ids_s, w_new)
    mu.index_copy_(0, ids_s, mu_new)
    nu.index_copy_(0, ids_s, nu_new)
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
    gradient exists); the tables update through lazy_row_adam, the four head
    scalars through ordinary Adam with the shared step count. On a card a
    replay of the step's graph (train/step_graph.py)."""

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
        for k, ids, grad in (("user_emb", users, d_u), ("anime_emb", anime, d_a)):
            lazy_row_adam(getattr(model, k).detach(), adam.mu[k], adam.nu[k], ids, grad,
                          scal, l2_reg_factor)
        _head_adam(state, d_head, scal)
        _keep_bn(model, new_bn)
    return loss.detach(), mse.detach()
