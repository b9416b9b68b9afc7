"""Two-tower embedding dot-product rating model, PyTorch.

Counterpart of anime_recommendations_tpu/models/two_tower.py:

    user id  -> Embedding(n_users, D)  \\
                                         cosine  -> Dense(1) -> BatchNorm -> sigmoid
    anime id -> Embedding(n_anime, D)  /

Numerics, as in the JAX package:
  * rows are L2-normalized with TF's epsilon clamp, x * rsqrt(max(sum(x^2),
    1e-12));
  * BatchNorm has Keras defaults (momentum 0.99, eps 1e-3): batch statistics
    in training, masked by the batch weights, moving averages at eval;
  * the loss is the weighted-mean BCE (probabilities clipped to [1e-7,
    1 - 1e-7]) plus l2 * sum(W^2) over BOTH full tables;
  * init is Keras': tables uniform(-0.05, 0.05), the Dense weight he_normal.

The functions are plain functions on tensors and return the new BatchNorm
state instead of writing it into the module's buffers: the training step
decides what to keep (train/trainer.py).

``take_rows`` is the JAX package's sorted-scatter gather
(``forward(..., sorted_scatter=...)``, the Trainer's ``sorted_scatter``
flag); here it is the plain gather, whose backward already sorts on the
card.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

TF_L2_NORM_EPS = 1e-12     # tf.linalg.l2_normalize clamp
KERAS_BCE_EPS = 1e-7       # Keras backend binary_crossentropy clip
KERAS_BN_MOMENTUM = 0.99
KERAS_BN_EPS = 1e-3

# The .npz keys of train/model_io.py, in both packages.
PARAM_KEYS = ("user_emb", "anime_emb", "dense_w", "dense_b", "bn_gamma", "bn_beta")
BUFFER_KEYS = ("moving_mean", "moving_var")
HEAD_KEYS = PARAM_KEYS[2:]
MERGES = ("cosine", "dot")


class BNState(NamedTuple):
    moving_mean: torch.Tensor  # []
    moving_var: torch.Tensor   # []


class TwoTower(nn.Module):
    """User and anime tables ([n, D] parameters), the four head scalars
    (parameters) and the BatchNorm moving statistics (buffers)."""

    def __init__(self, n_users: int, n_anime: int, embedding_size: int = 128,
                 *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.user_emb = nn.Parameter(torch.zeros(n_users, embedding_size, **kw))
        self.anime_emb = nn.Parameter(torch.zeros(n_anime, embedding_size, **kw))
        self.dense_w = nn.Parameter(torch.ones((), **kw))
        self.dense_b = nn.Parameter(torch.zeros((), **kw))
        self.bn_gamma = nn.Parameter(torch.ones((), **kw))
        self.bn_beta = nn.Parameter(torch.zeros((), **kw))
        self.register_buffer("moving_mean", torch.zeros((), **kw))
        self.register_buffer("moving_var", torch.ones((), **kw))

    def bn_state(self) -> BNState:
        return BNState(self.moving_mean, self.moving_var)

    def head_params(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, k) for k in HEAD_KEYS)

    def forward(self, users: torch.Tensor, anime: torch.Tensor,
                weights: torch.Tensor | None = None):
        """Eval mode: the predicted rating [B]. Train mode: (pred [B], new
        BNState) from the batch statistics; the buffers are left as they
        are (the caller keeps the new state or not)."""
        if not self.training:
            return predict(self, users, anime)
        return forward(self, self.bn_state(), users, anime, train=True, weights=weights)


def init_params(n_users: int, n_anime: int, embedding_size: int = 128, *,
                generator: torch.Generator, device=None) -> TwoTower:
    """Keras init drawn from ``generator`` (a CPU generator): tables
    uniform(-0.05, 0.05); dense_w he_normal on fan_in 1, a normal truncated
    to [-2, 2] times sqrt(2); dense_b 0, gamma 1, beta 0. Drawn on the CPU
    and then moved, so one seed gives one model on every device. The draws
    differ from jax.random's: parity with the JAX init is statistical."""
    model = TwoTower(n_users, n_anime, embedding_size)
    with torch.no_grad():
        model.user_emb.uniform_(-0.05, 0.05, generator=generator)
        model.anime_emb.uniform_(-0.05, 0.05, generator=generator)
        w = nn.init.trunc_normal_(torch.empty(()), 0.0, 1.0, -2.0, 2.0, generator=generator)
        model.dense_w.copy_(w * math.sqrt(2.0))
    return model.to(device)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, TF_L2_NORM_EPS))


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: the JAX package's sorted-scatter gather. JAX's
    take_rows gives the gather a backward that sorts the ids (unstably,
    ``jnp.argsort(stable=False)``) and sums each run of equal ids. Autograd's
    own index backward (``index_put_`` with accumulate) already does that on
    the card: it sorts the ids and sums each run in order, with no atomics,
    so its result does not vary between runs. On the CPU it sums in batch
    order, or, for a large batch on several threads, with atomic adds whose
    order may vary. Either way it differs from JAX's gradient only in f32
    rounding, so the gather needs no backward of its own."""
    return table[idx]


def cosine_merge(u_rows: torch.Tensor, a_rows: torch.Tensor) -> torch.Tensor:
    """Dot(normalize=True): rowwise cosine similarity. [B,D]x[B,D]->[B]."""
    return torch.sum(_l2_normalize(u_rows) * _l2_normalize(a_rows), dim=-1)


def dot_merge(u_rows: torch.Tensor, a_rows: torch.Tensor) -> torch.Tensor:
    """Unnormalized rowwise dot: not the reference head, a diagnostic
    variant of the per-step path (JAX two_tower.dot_merge)."""
    return torch.sum(u_rows * a_rows, dim=-1)


def head(head_params, cos: torch.Tensor, bn_state: BNState, train: bool,
         weights: torch.Tensor | None = None) -> tuple[torch.Tensor, BNState]:
    """Dense(1) -> BatchNorm -> sigmoid on the scalar cosine feature.

    ``head_params`` is (dense_w, dense_b, bn_gamma, bn_beta). In training,
    ``weights`` masks padded rows out of the batch statistics, so a ragged
    final batch matches unpadded math. Returns (pred, new BNState); the new
    state is detached from the graph."""
    dense_w, dense_b, bn_gamma, bn_beta = head_params
    z = dense_w * cos + dense_b
    if train:
        if weights is None:
            mean = torch.mean(z)
            var = torch.mean(torch.square(z - mean))
        else:
            denom = torch.clamp_min(torch.sum(weights), 1.0)
            mean = torch.sum(z * weights) / denom
            var = torch.sum(torch.square(z - mean) * weights) / denom
        new_state = BNState(
            moving_mean=(bn_state.moving_mean * KERAS_BN_MOMENTUM
                         + mean.detach() * (1.0 - KERAS_BN_MOMENTUM)),
            moving_var=(bn_state.moving_var * KERAS_BN_MOMENTUM
                        + var.detach() * (1.0 - KERAS_BN_MOMENTUM)),
        )
    else:
        mean, var = bn_state.moving_mean, bn_state.moving_var
        new_state = bn_state
    z_hat = (z - mean) * torch.rsqrt(var + KERAS_BN_EPS)
    return torch.sigmoid(bn_gamma * z_hat + bn_beta), new_state


def forward(model: TwoTower, bn_state: BNState, users: torch.Tensor,
            anime: torch.Tensor, train: bool, weights: torch.Tensor | None = None,
            sorted_scatter: bool | str = False,
            merge: str = "cosine") -> tuple[torch.Tensor, BNState]:
    """Gathers -> cosine (or ``merge="dot"``) -> head. Returns (pred [B],
    BNState).

    ``sorted_scatter``: False = plain gathers; True = take_rows on both
    tables; "user" = take_rows on the user table only."""
    if merge not in MERGES:
        raise ValueError(f"unknown merge {merge!r}")
    plain = lambda t, i: t[i]
    u_gather = take_rows if sorted_scatter else plain
    a_gather = take_rows if sorted_scatter is True else plain
    merge_fn = cosine_merge if merge == "cosine" else dot_merge
    cos = merge_fn(u_gather(model.user_emb, users), a_gather(model.anime_emb, anime))
    return head(model.head_params(), cos, bn_state, train=train, weights=weights)


def predict(model: TwoTower, users: torch.Tensor, anime: torch.Tensor) -> torch.Tensor:
    """Inference-mode rating prediction (model.predict parity)."""
    return forward(model, model.bn_state(), users, anime, train=False)[0]


def bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(pred, KERAS_BCE_EPS, 1.0 - KERAS_BCE_EPS)
    return -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))


def loss_and_metrics(
    model: TwoTower,
    bn_state: BNState,
    users: torch.Tensor,
    anime: torch.Tensor,
    ratings: torch.Tensor,
    weights: torch.Tensor,
    l2_reg_factor: float,
    train: bool,
    sorted_scatter: bool | str = False,
    merge: str = "cosine",
) -> tuple[torch.Tensor, tuple[torch.Tensor, BNState]]:
    """Weighted-mean BCE + full-table L2, plus the mse metric.
    Returns (loss, (mse, new_bn_state))."""
    pred, new_state = forward(model, bn_state, users, anime, train=train,
                              weights=weights, sorted_scatter=sorted_scatter, merge=merge)
    denom = torch.clamp_min(torch.sum(weights), 1.0)
    data_loss = torch.sum(bce(pred, ratings) * weights) / denom
    reg = l2_reg_factor * (
        torch.sum(torch.square(model.user_emb)) + torch.sum(torch.square(model.anime_emb))
    )
    mse = torch.sum(torch.square(pred - ratings) * weights) / denom
    return data_loss + reg, (mse, new_state)


@torch.no_grad()
def normalized_tables(model: TwoTower) -> tuple[torch.Tensor, torch.Tensor]:
    """L2-row-normalized (anime, user) tables, with the clamp that keeps a
    ~zero row at ~zero instead of minting inf/NaN rows."""
    return _l2_normalize(model.anime_emb), _l2_normalize(model.user_emb)


def params_from_numpy(arrays: Mapping[str, np.ndarray], device) -> TwoTower:
    """Build the model from the eight .npz arrays of train/model_io.py
    (user_emb, anime_emb, dense_w, dense_b, bn_gamma, bn_beta, moving_mean,
    moving_var) on ``device``, in eval mode. Given the JAX parameters as
    numpy, the port computes what the JAX model computes."""
    missing = [k for k in PARAM_KEYS + BUFFER_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"model arrays lack {missing}")
    user = np.asarray(arrays["user_emb"], np.float32)
    anime = np.asarray(arrays["anime_emb"], np.float32)
    if user.ndim != 2 or anime.ndim != 2 or user.shape[1] != anime.shape[1]:
        raise ValueError(f"tables must be [n, D] with one D: {user.shape}, {anime.shape}")
    model = TwoTower(user.shape[0], anime.shape[0], user.shape[1], device=device)
    with torch.no_grad():
        for key in PARAM_KEYS + BUFFER_KEYS:
            value = np.asarray(arrays[key], np.float32)
            target = getattr(model, key)
            if value.size != target.numel():
                raise ValueError(f"{key}: {value.shape} does not fit {tuple(target.shape)}")
            target.copy_(torch.from_numpy(value.reshape(target.shape)))
    return model.eval()
