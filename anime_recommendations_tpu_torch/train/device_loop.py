"""Device-resident epoch loop.

Counterpart of anime_recommendations_tpu/train/device_loop.py. The training
data is uploaded to the device once (``stage``), padded to a batch multiple
with weight-0 rows, which are exact no-ops in the loss, the metrics and the
BatchNorm statistics. Each epoch permutes SHUFFLE_BLOCK-row granules of it
on the device and runs its batches, keeping the per-batch loss, mse and
weight on the device: there is no host sync until the epoch ends.

On the TPU an epoch is one launched program (lax.scan). Here it is a Python
loop of steps with no sync in it; capturing it in a CUDA graph is later work
(ROADMAP.md). The fused optimizers run the JAX scan's software pipeline
(``_fused_epoch``): each step consumes rows gathered at the end of the one
before and gathers the next batch's rows from the tables it just updated.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from anime_recommendations_tpu_torch.data.dataset import RatingsDataset
from anime_recommendations_tpu_torch.models.two_tower import BNState, TwoTower
from anime_recommendations_tpu_torch.train.trainer import (
    FUSED_OPTIMIZERS,
    OPTIMIZERS,
    TrainState,
    eval_step,
    train_step,
)

SHUFFLE_BLOCK = 512  # granule of the per-epoch shuffle (see stage())


class DeviceData(NamedTuple):
    users: torch.Tensor    # [n_pad] int32
    anime: torch.Tensor    # [n_pad] int32
    ratings: torch.Tensor  # [n_pad] f32
    weights: torch.Tensor  # [n_pad] f32; 0 marks padding

    @property
    def n(self) -> int:
        return self.users.shape[0]


def stage(ds: RatingsDataset, batch_size: int, seed: int | None = None, *,
          device) -> DeviceData:
    """Upload a dataset once, padded to a batch multiple with weight-0 rows.

    With ``seed`` set, rows are shuffled once here on the host with
    numpy.random.default_rng(seed), as in the JAX package; each epoch then
    permutes SHUFFLE_BLOCK-row granules (train_epoch), so granules are
    random example sets and batches random unions of granules. ``seed=None``
    keeps dataset order (shuffle-off runs that must match the per-step path
    batch for batch)."""
    n = len(ds)
    n_pad = -(-max(n, 1) // batch_size) * batch_size
    pad = n_pad - n
    order = (
        np.random.default_rng(seed).permutation(n)
        if (n and seed is not None) else np.arange(n)
    )
    cols = (
        (ds.users[order], np.int32),
        (ds.anime[order], np.int32),
        (ds.ratings[order], np.float32),
        (np.ones(n, np.float32), np.float32),
    )
    return DeviceData(*(torch.from_numpy(np.pad(x.astype(dt), (0, pad))).to(device)
                        for x, dt in cols))


def granule_shuffle(data: DeviceData, generator: torch.Generator) -> DeviceData:
    """Permute the data's granules of g rows on its device, g =
    min(SHUFFLE_BLOCK, n // 64) (at least 1), so small datasets still have
    ~64 granules; the tail of fewer than g rows keeps its place. The
    permutation is drawn from ``generator`` (a CPU generator)."""
    n = data.n
    g = int(max(1, min(SHUFFLE_BLOCK, n // 64)))
    n_head = (n // g) * g
    perm = torch.randperm(n_head // g, generator=generator).to(data.users.device)

    def shuf(x):
        head = x[:n_head].view(n_head // g, g)[perm].reshape(n_head)
        return head if n_head == n else torch.cat([head, x[n_head:]])

    return DeviceData(*(shuf(x) for x in data))


def train_epoch(
    state: TrainState,
    data: DeviceData,
    generator: torch.Generator,
    lr: float,
    batch_size: int,
    l2_reg_factor: float,
    shuffle: bool = True,
    sorted_scatter: bool | str = False,
    optimizer: str = "adam",
) -> tuple[TrainState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One epoch on the device. Returns (state, losses[nb], mses[nb],
    wsums[nb]), all on the device. ``optimizer="lazy_adam"`` takes the
    row-sparse step of train/lazy.py, whose losses exclude the L2 term.
    ``sorted_scatter``: the adam step's gathers (two_tower.forward)."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    nb = data.n // batch_size
    if shuffle:
        data = granule_shuffle(data, generator)
    wsums = data.weights[:nb * batch_size].view(nb, batch_size).sum(dim=1)
    if optimizer in FUSED_OPTIMIZERS:
        # The bf16m variant is the same code: the state's moment dtype
        # selects the storage.
        state, losses, mses = _fused_epoch(state, data, lr, batch_size, l2_reg_factor)
        return state, losses, mses, wsums
    if optimizer == "lazy_adam":
        from anime_recommendations_tpu_torch.train.lazy import lazy_train_step as step_fn
    else:
        step_fn = functools.partial(train_step, sorted_scatter=sorted_scatter)
    losses, mses = [], []
    for i in range(nb):
        state, loss, mse = step_fn(
            state, _batch(data.users, i, batch_size), _batch(data.anime, i, batch_size),
            _batch(data.ratings, i, batch_size), _batch(data.weights, i, batch_size),
            lr, l2_reg_factor)
        losses.append(loss)
        mses.append(mse)
    return state, torch.stack(losses), torch.stack(mses), wsums


def _batch(x: torch.Tensor, i: int, batch_size: int) -> torch.Tensor:
    return x[i * batch_size:(i + 1) * batch_size]


def _fused_epoch(state: TrainState, data: DeviceData, lr: float, batch_size: int,
                 l2_reg_factor: float, kernel_gather: bool = False,
                 ) -> tuple[TrainState, torch.Tensor, torch.Tensor]:
    """The fused optimizers' epoch over ``data`` as it is (no shuffle), the
    JAX scan's software pipeline: a prologue gathers batch 0's rows, then
    step i consumes the rows step i-1 gathered and gathers batch (i+1) % nb's
    (the last step's wrap to batch 0 is discarded). ``kernel_gather``: the
    gather runs inside the update kernel (K5) instead of after it; train_epoch
    passes False, as the JAX device loop does. Returns (state, losses[nb],
    mses[nb])."""
    from anime_recommendations_tpu_torch.train.fused import fused_train_step_pipelined

    nb = data.n // batch_size
    users = [_batch(data.users, i, batch_size) for i in range(nb)]
    anime = [_batch(data.anime, i, batch_size) for i in range(nb)]
    u_rows = state.model.user_emb.detach()[users[0]]
    a_rows = state.model.anime_emb.detach()[anime[0]]
    losses, mses = [], []
    for i in range(nb):
        nxt = (i + 1) % nb
        state, loss, mse, u_rows, a_rows = fused_train_step_pipelined(
            state, u_rows, a_rows, users[i], anime[i], _batch(data.ratings, i, batch_size),
            _batch(data.weights, i, batch_size), users[nxt], anime[nxt], lr, l2_reg_factor,
            kernel_gather=kernel_gather)
        losses.append(loss)
        mses.append(mse)
    return state, torch.stack(losses), torch.stack(mses)


@torch.no_grad()
def eval_epoch(
    model: TwoTower,
    bn_state: BNState,
    data: DeviceData,
    batch_size: int,
    l2_reg_factor: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted-mean (loss, mse) over the staged holdout, on the device."""
    nb = data.n // batch_size
    l_sum = m_sum = w_sum = torch.zeros((), device=data.weights.device)
    for i in range(nb):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        ls, ms, w = eval_step(model, bn_state, data.users[sl], data.anime[sl],
                              data.ratings[sl], data.weights[sl], l2_reg_factor)
        l_sum, m_sum, w_sum = l_sum + ls, m_sum + ms, w_sum + w
    w = torch.clamp_min(w_sum, 1.0)
    return l_sum / w, m_sum / w
