"""The plain reference of row-sparse Adam (LazyAdam): the two-tower model's
training epoch as the port's train/lazy.py documents it, in plain PyTorch.

Like reference.py, whose helpers it uses, it imports nothing of the port and
is given the seeded inputs and the epoch's batches (reference.epoch_batches).
Each step, over the batch's rows:

* the loss is the mean binary cross-entropy (Keras's clip at 1e-7) through
  the head in training mode (Dense(1), BatchNorm on the batch's statistics,
  sigmoid), with no L2 term: the weighted mean over the device loop's
  batch, whose empty slots weigh 0;
* for each table row r that the batch touches, g_r is the sum of the loss's
  gradients at r's positions plus 2 l2 w_r, once per step, however often r
  occurs;
* m_r <- b1 m_r + (1 - b1) g_r and v_r <- b2 v_r + (1 - b2) g_r^2, then
  w_r <- w_r - lr (m_r / bc1) / (sqrt(v_r / bc2) + eps), with
  bc = 1 - b^t at the shared step count t;
* a row no position touches keeps w, m and v;
* the four head scalars take plain Adam with the same count;
* an empty slot of a batch (a batch of fewer rows than the batch size) is
  the device loop's padding: an example of user 0 and item 0 with weight 0.
  It adds nothing to the loss or to the BatchNorm statistics, but it is a
  position of row 0 of both tables, which the step therefore touches (the
  port's update and the JAX package's treat it so).

The two tables are held as one array, the items' rows after the users',
so that one torch.unique over a step's user and item rows finds the rows it
touches and one index_add_ sums their gradients; the four head scalars are
one vector. The epoch's rows go to the device once. The holdout's loss is
reference.model_loss in evaluation mode, with the L2 term over both whole
tables, as the port's evaluation has it. ``dtype`` computes everything in
another precision (the control). Matrix products, of which there are none,
would run with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import (
    ADAM_EPS,
    B1,
    B2,
    BCE_EPS,
    BN_EPS,
    BN_MOMENTUM,
    LEAVES,
    _norm,
    model_loss,
    no_tf32,
    normalize,
)

HEAD = LEAVES[2:]


def data_loss(u_rows: torch.Tensor, a_rows: torch.Tensor, head: dict, ratings: torch.Tensor):
    """(loss, batch mean, batch variance) of one batch's gathered rows: the
    mean BCE through the training-mode head, no L2 term."""
    cos = (normalize(u_rows) * normalize(a_rows)).sum(-1)
    z = head["dense_w"] * cos + head["dense_b"]
    mean = z.mean()
    var = ((z - mean) ** 2).mean()
    pred = torch.sigmoid(head["bn_gamma"] * (z - mean) * torch.rsqrt(var + BN_EPS)
                         + head["bn_beta"])
    pred = torch.clamp(pred, BCE_EPS, 1 - BCE_EPS)
    return -(ratings * torch.log(pred) + (1 - ratings) * torch.log1p(-pred)).mean(), mean, var


@torch.no_grad()
def row_adam(w: torch.Tensor, m: torch.Tensor, v: torch.Tensor, ids: torch.Tensor,
             g_pos: torch.Tensor, t: int, lr: float, l2: float) -> tuple:
    """One step of row-sparse Adam on a table, in place: ``ids`` the rows of
    the step's positions, ``g_pos`` the loss's gradient at each position.
    Returns the touched rows and their gradients g_r."""
    uniq, inv = torch.unique(ids, return_inverse=True)
    g = torch.zeros(len(uniq), w.shape[1], dtype=w.dtype, device=w.device)
    g.index_add_(0, inv, g_pos.to(w.dtype))
    w_r = w[uniq]
    g += 2 * l2 * w_r
    m_r = B1 * m[uniq] + (1 - B1) * g
    v_r = B2 * v[uniq] + (1 - B2) * g * g
    m[uniq], v[uniq] = m_r, v_r
    w[uniq] = w_r - lr * (m_r / (1 - B1 ** t)) / (torch.sqrt(v_r / (1 - B2 ** t)) + ADAM_EPS)
    return uniq, g


def train_epoch(init: dict, data: tuple, batches: list, lr: float, l2: float, holdout: tuple,
                batch_size: int, dtype: torch.dtype = torch.float32,
                half_batch: bool = False) -> dict:
    """Row-sparse Adam steps from ``init`` (the parameters and moving
    statistics), one per entry of ``batches`` (row indices into ``data``,
    the train split's (users, items, ratings) on the device; an entry of
    fewer than ``batch_size`` rows is a padded batch), at learning rate
    ``lr``. Returns what reference.train_epoch returns: each step's loss at
    the parameters it starts from, each leaf's gradient norm at the first
    step (a table's over its touched rows, decay included), each leaf's
    first moment's norm and change norm after the last step, and the
    holdout's loss then. ``half_batch`` leaves out the second half of every
    batch (a fault the check has to catch)."""
    n_users = init["user_emb"].shape[0]
    table = torch.cat([init["user_emb"], init["anime_emb"]]).to(dtype)
    head = torch.stack([init[k] for k in HEAD]).to(dtype)
    m, v = torch.zeros_like(table), torch.zeros_like(table)
    hm, hv = torch.zeros_like(head), torch.zeros_like(head)
    moving = [init["moving_mean"].to(dtype).clone(), init["moving_var"].to(dtype).clone()]
    device = data[0].device
    taken = [rows[:len(rows) // 2] if half_batch else rows for rows in batches]
    lengths = [len(rows) for rows in taken]
    idx = torch.as_tensor(np.concatenate(taken), device=device)
    users, items, ratings = data[0][idx], data[1][idx] + n_users, data[2][idx].to(dtype)
    del idx
    pad_ids = torch.tensor([0, n_users], device=device)
    losses, out = [], {}
    with no_tf32():
        for t, (rows, hi, n) in enumerate(zip(batches, np.cumsum(lengths), lengths), start=1):
            lo = hi - n
            ids = torch.cat([users[lo:hi], items[lo:hi]])
            rows_g = table[ids].requires_grad_()
            h = head.clone().requires_grad_()
            loss, mean, var = data_loss(rows_g[:n], rows_g[n:], dict(zip(HEAD, h)),
                                        ratings[lo:hi])
            g_rows, g_head = torch.autograd.grad(loss, [rows_g, h])
            losses.append(loss.detach())
            with torch.no_grad():
                if len(rows) < batch_size:
                    ids = torch.cat([ids, pad_ids])
                    g_rows = torch.cat([g_rows, g_rows.new_zeros(2, g_rows.shape[1])])
                uniq, g = row_adam(table, m, v, ids, g_rows, t, lr, l2)
                bc1, bc2 = 1 - B1 ** t, 1 - B2 ** t
                hm.mul_(B1).add_(g_head * (1 - B1))
                hv.mul_(B2).add_(g_head * g_head * (1 - B2))
                head.sub_((hm / bc1) / (torch.sqrt(hv / bc2) + ADAM_EPS) * lr)
                moving[0] = moving[0] * BN_MOMENTUM + mean.detach() * (1 - BN_MOMENTUM)
                moving[1] = moving[1] * BN_MOMENTUM + var.detach() * (1 - BN_MOMENTUM)
            if t == 1:
                user = uniq < n_users
                out["grad_norms"] = {"user_emb": _norm(g[user]), "anime_emb": _norm(g[~user]),
                                     **{k: _norm(x) for k, x in zip(HEAD, g_head)}}
        with torch.no_grad():
            p = {"user_emb": table[:n_users], "anime_emb": table[n_users:],
                 **dict(zip(HEAD, head.unbind()))}
            out["losses"] = torch.stack(losses).double().cpu().tolist()
            out["moment_norms"] = {"user_emb": _norm(m[:n_users]),
                                   "anime_emb": _norm(m[n_users:]),
                                   **{k: _norm(x) for k, x in zip(HEAD, hm)}}
            out["change_norms"] = {k: _norm(p[k].float() - init[k].float()) for k in LEAVES}
            u, a, r = holdout
            out["val_loss"] = float(model_loss(p, moving, u, a, r.to(dtype), l2, False)[0])
    return out
