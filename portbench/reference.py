"""The plain reference: the two-tower model's training epoch and the
retrieval scans, in plain PyTorch.

It imports nothing of the port and takes nothing the port made: it is given
the seeded inputs (datagen.py) and works out again whatever the port derives
from them (normalized tables, the folded head, masks). The model follows the
reference project's Keras definition: both ids embedded, the rows L2
normalized (TensorFlow's clamp of the squared norm at 1e-12), their dot
product, Dense(1), BatchNorm (momentum 0.99, epsilon 1e-3, batch statistics
in training), sigmoid; binary cross-entropy with Keras's clip at 1e-7 plus
l2 times the sum of squares of both whole tables; Adam (0.9, 0.999, 1e-7)
with bias correction; the learning rate of an epoch from the reference
project's schedule (a linear ramp, a sustain, an exponential decay). The
epoch's batches follow the device loop's order, worked out again from the
run's seeds (``epoch_batches``). ``dtype`` computes everything in another
precision (the control). Matrix products run with TF32 off.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

TF_EPS = 1e-12
BCE_EPS = 1e-7
BN_MOMENTUM = 0.99
BN_EPS = 1e-3
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-7
LEAVES = ("user_emb", "anime_emb", "dense_w", "dense_b", "bn_gamma", "bn_beta")
SHUFFLE_BLOCK = 512   # rows of a granule of the per-epoch shuffle


@contextlib.contextmanager
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), TF_EPS))


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.detach().double()))


def model_loss(p: dict, moving: tuple, users, anime, ratings, l2: float, train: bool):
    """(loss, batch mean, batch variance) of one batch: the mean BCE plus
    the L2 term; in training the BatchNorm uses the batch's statistics,
    otherwise the moving ones."""
    cos = (normalize(p["user_emb"][users]) * normalize(p["anime_emb"][anime])).sum(-1)
    z = p["dense_w"] * cos + p["dense_b"]
    if train:
        mean = z.mean()
        var = ((z - mean) ** 2).mean()
    else:
        mean, var = moving
    pred = torch.sigmoid(p["bn_gamma"] * (z - mean) * torch.rsqrt(var + BN_EPS) + p["bn_beta"])
    pred = torch.clamp(pred, BCE_EPS, 1 - BCE_EPS)
    bce = -(ratings * torch.log(pred) + (1 - ratings) * torch.log1p(-pred)).mean()
    reg = l2 * ((p["user_emb"] ** 2).sum() + (p["anime_emb"] ** 2).sum())
    return bce + reg, mean, var


def lr_for_epoch(cfg: dict, epoch: int) -> float:
    """The configuration's learning rate of ``epoch`` (the reference
    project's lrfn): start_lr ramping linearly to max_lr over rampup_epochs,
    max_lr for sustain_epochs, then min_lr + (max_lr - min_lr) decayed by
    exp_decay an epoch."""
    ramp, sustain = cfg["rampup_epochs"], cfg["sustain_epochs"]
    if epoch < ramp:
        return (cfg["max_lr"] - cfg["start_lr"]) / ramp * epoch + cfg["start_lr"]
    if epoch < ramp + sustain:
        return cfg["max_lr"]
    return (cfg["max_lr"] - cfg["min_lr"]) * cfg["exp_decay"] ** (epoch - ramp - sustain) \
        + cfg["min_lr"]


def epoch_batches(n: int, batch: int, stage_seed: int, epoch_seed: int) -> list[np.ndarray]:
    """The rows of the train split that each step of one shuffled epoch
    takes, in order. The device loop's order: the rows shuffled once
    (numpy's default_rng(stage_seed)), padded with empty slots to a batch
    multiple, then the granules of g = min(SHUFFLE_BLOCK, n_pad // 64) slots
    permuted (torch.randperm on a CPU generator seeded epoch_seed; the tail
    of fewer than g slots stays), then cut into batches; an empty slot
    carries no row."""
    n_pad = -(-max(n, 1) // batch) * batch
    slots = np.full(n_pad, -1, np.int64)
    slots[:n] = np.random.default_rng(stage_seed).permutation(n)
    g = int(max(1, min(SHUFFLE_BLOCK, n_pad // 64)))
    n_head = (n_pad // g) * g
    perm = torch.randperm(n_pad // g, generator=torch.Generator().manual_seed(epoch_seed))
    slots[:n_head] = slots[:n_head].reshape(-1, g)[perm.numpy()].reshape(-1)
    return [b[b >= 0] for b in slots.reshape(-1, batch)]


def train_epoch(init: dict, data: tuple, batches: list, lr: float, l2: float, holdout: tuple,
                dtype: torch.dtype = torch.float32, half_batch: bool = False) -> dict:
    """Adam steps from ``init`` (the parameters and moving statistics), one
    per entry of ``batches`` (row indices into ``data``, the train split's
    (users, anime, ratings) on the device), at learning rate ``lr``.
    Returns each step's loss at the parameters it starts from, each leaf's
    gradient norm at the first step, each leaf's first moment's norm and
    change norm after the last step, and the holdout's loss then.
    ``half_batch`` leaves out the second half of every batch (a fault the
    check has to catch)."""
    p = {k: init[k].to(dtype).clone().requires_grad_() for k in LEAVES}
    moving = [init["moving_mean"].to(dtype).clone(), init["moving_var"].to(dtype).clone()]
    mu = {k: torch.zeros_like(p[k]) for k in LEAVES}
    nu = {k: torch.zeros_like(p[k]) for k in LEAVES}
    device = data[0].device
    losses = []
    out = {"grad_norms": {}, "change_norms": {}}
    for t, rows in enumerate(batches, start=1):
        if half_batch:
            rows = rows[:len(rows) // 2]
        idx = torch.as_tensor(rows, device=device)
        users, anime, ratings = (x[idx] for x in data)
        loss, mean, var = model_loss(p, moving, users, anime, ratings.to(dtype), l2, True)
        grads = torch.autograd.grad(loss, [p[k] for k in LEAVES])
        losses.append(loss.detach())
        if t == 1:
            out["grad_norms"] = {k: _norm(g) for k, g in zip(LEAVES, grads)}
        bc1, bc2 = 1 - B1 ** t, 1 - B2 ** t
        with torch.no_grad():
            for k, g in zip(LEAVES, grads):
                mu[k].mul_(B1).add_(g * (1 - B1))
                nu[k].mul_(B2).add_(g * g * (1 - B2))
                p[k].sub_((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS) * lr)
            moving[0] = moving[0] * BN_MOMENTUM + mean.detach() * (1 - BN_MOMENTUM)
            moving[1] = moving[1] * BN_MOMENTUM + var.detach() * (1 - BN_MOMENTUM)
    with torch.no_grad():
        out["losses"] = torch.stack(losses).double().cpu().tolist()
        out["moment_norms"] = {k: _norm(mu[k]) for k in LEAVES}
        out["change_norms"] = {k: _norm(p[k].float() - init[k].float()) for k in LEAVES}
        users, anime, ratings = holdout
        out["val_loss"] = float(model_loss(p, moving, users, anime, ratings.to(dtype), l2,
                                           False)[0])
    return out


def head_affine(params: dict) -> tuple[float, float]:
    """The eval-mode head sigmoid(gamma (w cos + b - mean) / sqrt(var + eps)
    + beta) as sigmoid(alpha cos + beta')."""
    inv = float(torch.rsqrt(params["moving_var"] + BN_EPS))
    gamma, w, b = (float(params[k]) for k in ("bn_gamma", "dense_w", "dense_b"))
    return gamma * w * inv, gamma * (b - float(params["moving_mean"])) * inv + float(params["bn_beta"])


@torch.no_grad()
def scores(table: torch.Tensor, queries: torch.Tensor, head=None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Every row's score for each query: the cosine of normalized rows
    (queries @ table.T), or the head's sigmoid of it. [Q, N] f32."""
    with no_tf32():
        s = (queries.to(dtype) @ table.to(dtype).T).float()
    if head is not None:
        s = torch.sigmoid(head[0] * s + head[1])
    return s

