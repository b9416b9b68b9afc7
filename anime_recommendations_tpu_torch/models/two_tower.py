"""Two-tower embedding dot-product rating model, PyTorch.

Counterpart of anime_recommendations_tpu/models/two_tower.py, serving half:

    user id  -> Embedding(n_users, D)  \\
                                         cosine  -> Dense(1) -> BatchNorm -> sigmoid
    anime id -> Embedding(n_anime, D)  /

Rows are L2-normalized with TF's epsilon clamp, x * rsqrt(max(sum(x^2),
1e-12)), as in the JAX package. The head here is the eval-mode head
(BatchNorm on its moving statistics, Keras eps 1e-3). Train-mode BatchNorm,
the loss and the optimizers come with the training port (ROADMAP.md).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

TF_L2_NORM_EPS = 1e-12     # tf.linalg.l2_normalize clamp
KERAS_BN_EPS = 1e-3

# The .npz keys of train/model_io.py, in both packages.
PARAM_KEYS = ("user_emb", "anime_emb", "dense_w", "dense_b", "bn_gamma", "bn_beta")
BUFFER_KEYS = ("moving_mean", "moving_var")


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

    def forward(self, users: torch.Tensor, anime: torch.Tensor) -> torch.Tensor:
        """Predicted rating [B] of (user row, anime row) pairs (eval mode)."""
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm and the loss come with the training port "
                "(ROADMAP.md Queue 1); call .eval() to predict"
            )
        return predict(self, users, anime)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, TF_L2_NORM_EPS))


def cosine_merge(u_rows: torch.Tensor, a_rows: torch.Tensor) -> torch.Tensor:
    """Dot(normalize=True): rowwise cosine similarity. [B,D]x[B,D]->[B]."""
    return torch.sum(_l2_normalize(u_rows) * _l2_normalize(a_rows), dim=-1)


def head(model: TwoTower, cos: torch.Tensor) -> torch.Tensor:
    """Dense(1) -> eval-mode BatchNorm -> sigmoid on the scalar cosine."""
    z = model.dense_w * cos + model.dense_b
    z_hat = (z - model.moving_mean) * torch.rsqrt(model.moving_var + KERAS_BN_EPS)
    return torch.sigmoid(model.bn_gamma * z_hat + model.bn_beta)


def predict(model: TwoTower, users: torch.Tensor, anime: torch.Tensor) -> torch.Tensor:
    """Inference-mode rating prediction (model.predict parity)."""
    cos = cosine_merge(model.user_emb[users], model.anime_emb[anime])
    return head(model, cos)


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
