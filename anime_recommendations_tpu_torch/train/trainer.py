"""Training loop: dense Adam with Keras parity, and the Trainer.

Counterpart of anime_recommendations_tpu/train/trainer.py, replacing the
reference's Keras model.fit stack:
  * per-epoch LearningRateScheduler -> lr_for_epoch, a host float per epoch
  * ModelCheckpoint(best val_loss)  -> best-state retention (+ torch.save)
  * EarlyStopping(patience=3, restore_best_weights=True)
  * history csv                     -> the frame loss, mse, val_loss, val_mse, lr

The state is mutable: a step updates the model's parameters and BatchNorm
buffers and the Adam moments in place and returns the same TrainState. The
Adam state is explicit (count, and mu/nu per parameter name), so the dense
and the fused paths share it. ``train_step`` is optax.scale_by_adam(b1=0.9,
b2=0.999, eps=1e-7) with -lr applied outside, written as tensor ops; the
gradients come from autograd over ``loss_and_metrics``.
"""

from __future__ import annotations

import time
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import pandas as pd
import torch

from anime_recommendations_tpu_torch.data.dataset import Batch, RatingsDataset
from anime_recommendations_tpu_torch.models.two_tower import (
    BUFFER_KEYS,
    MERGES,
    PARAM_KEYS,
    BNState,
    TwoTower,
    init_params,
    loss_and_metrics,
    params_from_numpy,
)
from anime_recommendations_tpu_torch.ops.fused_adam import adam_scalars
from anime_recommendations_tpu_torch.train.schedule import lr_for_epoch

KERAS_ADAM_EPS = 1e-7
B1, B2 = 0.9, 0.999
TABLE_KEYS = PARAM_KEYS[:2]
FUSED_OPTIMIZERS = ("fused_adam", "fused_adam_bf16m")
OPTIMIZERS = ("adam", "lazy_adam") + FUSED_OPTIMIZERS


@dataclass
class AdamState:
    count: int                      # Adam steps taken
    mu: dict[str, torch.Tensor]     # first moment per parameter name
    nu: dict[str, torch.Tensor]     # second moment per parameter name


@dataclass
class TrainState:
    model: TwoTower                 # parameters + BatchNorm buffers
    adam: AdamState


@dataclass
class TrainResult:
    state: TrainState
    history: pd.DataFrame
    best_epoch: int
    best_val_loss: float
    epochs_run: int
    examples_per_sec: float


def init_train_state(n_users: int, n_anime: int, embedding_size: int, *,
                     generator: torch.Generator, device) -> TrainState:
    model = init_params(n_users, n_anime, embedding_size, generator=generator,
                        device=device)
    zeros = lambda: {k: torch.zeros_like(getattr(model, k).detach()) for k in PARAM_KEYS}
    return TrainState(model=model, adam=AdamState(count=0, mu=zeros(), nu=zeros()))


def cast_table_moments(state: TrainState, dtype: torch.dtype) -> TrainState:
    """Store the embedding tables' Adam moments in ``dtype`` (bf16 for
    fused_adam_bf16m: half the moment bytes; the update math stays f32).
    The head scalars' moments stay f32."""
    for moments in (state.adam.mu, state.adam.nu):
        for k in TABLE_KEYS:
            moments[k] = moments[k].to(dtype)
    return state


def train_state_to_numpy(state: TrainState) -> dict[str, np.ndarray]:
    """The state's leaves as f32 numpy, under the JAX TrainState's names:
    the six parameters, moving_mean, moving_var, ``mu.<name>``,
    ``nu.<name>`` (bf16 moments travel as f32) and ``count``."""
    out = {k: getattr(state.model, k).detach().float().cpu().numpy()
           for k in PARAM_KEYS + BUFFER_KEYS}
    for prefix, moments in (("mu", state.adam.mu), ("nu", state.adam.nu)):
        for k in PARAM_KEYS:
            out[f"{prefix}.{k}"] = moments[k].detach().float().cpu().numpy()
    out["count"] = np.asarray(state.adam.count, np.int32)
    return out


def train_state_from_numpy(arrays: Mapping[str, np.ndarray], device,
                           moment_dtype: torch.dtype = torch.float32) -> TrainState:
    """Inverse of train_state_to_numpy, on ``device``; the tables' moments
    are cast back to ``moment_dtype``."""
    model = params_from_numpy(arrays, device).train()
    moments = []
    for prefix in ("mu", "nu"):
        m = {}
        for k in PARAM_KEYS:
            t = torch.from_numpy(np.array(arrays[f"{prefix}.{k}"], np.float32)).to(device)
            m[k] = t.to(moment_dtype) if k in TABLE_KEYS else t
        moments.append(m)
    return TrainState(model=model, adam=AdamState(int(arrays["count"]), *moments))


def bias_corrections(step: int) -> tuple[float, float]:
    """(1 - b1^step, 1 - b2^step) in f32."""
    s = adam_scalars(step, 0.0, 0.0, B1, B2, KERAS_ADAM_EPS)
    return s.bc1, s.bc2


def _keep_bn(model: TwoTower, new_bn: BNState) -> None:
    model.moving_mean.copy_(new_bn.moving_mean)
    model.moving_var.copy_(new_bn.moving_var)


def train_step(
    state: TrainState,
    users: torch.Tensor,
    anime: torch.Tensor,
    ratings: torch.Tensor,
    weights: torch.Tensor,
    lr: float,
    l2_reg_factor: float,
    merge: str = "cosine",
) -> tuple[TrainState, torch.Tensor, torch.Tensor]:
    """One dense-Adam step. Returns (state, batch_loss, batch_mse), the last
    two 0-dim device tensors (no host sync)."""
    model, adam = state.model, state.adam
    params = [getattr(model, k) for k in PARAM_KEYS]
    loss, (mse, new_bn) = loss_and_metrics(
        model, model.bn_state(), users, anime, ratings, weights, l2_reg_factor,
        True, merge=merge)
    grads = torch.autograd.grad(loss, params)
    t = adam.count + 1
    bc1, bc2 = bias_corrections(t)
    with torch.no_grad():
        for k, p, g in zip(PARAM_KEYS, params, grads):
            mu, nu = adam.mu[k], adam.nu[k]
            mu.mul_(B1).add_(g * (1 - B1))          # (1-b1)*g + b1*mu
            nu.mul_(B2).add_(torch.square(g) * (1 - B2))
            p.sub_((mu / bc1) / (torch.sqrt(nu / bc2) + KERAS_ADAM_EPS) * lr)
        _keep_bn(model, new_bn)
    adam.count = t
    return state, loss.detach(), mse.detach()


@torch.no_grad()
def eval_step(
    model: TwoTower,
    bn_state: BNState,
    users: torch.Tensor,
    anime: torch.Tensor,
    ratings: torch.Tensor,
    weights: torch.Tensor,
    l2_reg_factor: float,
    merge: str = "cosine",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted sums for exact epoch-level validation aggregates."""
    loss, (mse, _) = loss_and_metrics(model, bn_state, users, anime, ratings,
                                      weights, l2_reg_factor, False, merge=merge)
    w = torch.sum(weights)
    return loss * w, mse * w, w


def batch_to_device(batch: Batch, device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(np.asarray(x)).to(device)
                 for x in (batch.users, batch.anime, batch.ratings, batch.weights))


def _snapshot(model: TwoTower) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@dataclass
class Trainer:
    embedding_size: int = 128
    l2_reg_factor: float = 1e-4
    batch_size: int = 10_000
    epochs: int = 20
    start_lr: float = 1e-5
    max_lr: float = 5e-5
    min_lr: float = 1e-5
    rampup_epochs: int = 5
    sustain_epochs: int = 0
    exp_decay: float = 0.8
    patience: int = 3
    seed: int = 0
    shuffle_each_epoch: bool = True
    verbose: bool = True
    checkpoint_dir: str | None = None
    log_fn: Any = field(default=print)
    # Each epoch through train/device_loop.py: data staged on the device
    # once, a granule shuffle per epoch, no host sync until the epoch ends.
    device_loop: bool = False
    # "adam" = dense Keras-parity Adam; "fused_adam" = the same semantics
    # through the K1 kernel per table (train/fused.py); "fused_adam_bf16m" =
    # fused_adam with bf16 table moments, stochastically rounded;
    # "lazy_adam" = row-sparse Adam on the batch's rows only (train/lazy.py).
    optimizer: str = "adam"
    merge: str = "cosine"
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(
                f"unknown optimizer {self.optimizer!r}: choose 'adam' (exact Keras "
                "parity), 'fused_adam' (same semantics, one kernel pass per table), "
                "'fused_adam_bf16m' (bf16-stored table moments) or 'lazy_adam' "
                "(row-sparse)"
            )
        if self.merge not in MERGES:
            raise ValueError(f"unknown merge {self.merge!r}")
        if self.merge != "cosine" and (self.device_loop or self.optimizer != "adam"):
            raise ValueError(
                "merge='dot' is a per-step-path diagnostic: use "
                "optimizer='adam' with device_loop=False"
            )

    def _init_state(self, generator: torch.Generator, n_users: int, n_anime: int) -> TrainState:
        state = init_train_state(n_users, n_anime, self.embedding_size,
                                 generator=generator, device=self.device)
        if self.optimizer == "fused_adam_bf16m":
            state = cast_table_moments(state, torch.bfloat16)
        return state

    def _train_step(self, state, batch, lr):
        users, anime, ratings, weights = batch
        if self.optimizer == "lazy_adam":
            from anime_recommendations_tpu_torch.train.lazy import lazy_train_step

            return lazy_train_step(state, users, anime, ratings, weights, lr,
                                   self.l2_reg_factor)
        if self.optimizer in FUSED_OPTIMIZERS:
            from anime_recommendations_tpu_torch.train.fused import fused_train_step

            return fused_train_step(state, users, anime, ratings, weights, lr,
                                    self.l2_reg_factor)
        return train_step(state, users, anime, ratings, weights, lr,
                          self.l2_reg_factor, self.merge)

    def lr(self, epoch: int) -> float:
        return lr_for_epoch(
            epoch,
            start_lr=self.start_lr,
            max_lr=self.max_lr,
            min_lr=self.min_lr,
            rampup_epochs=self.rampup_epochs,
            sustain_epochs=self.sustain_epochs,
            exp_decay=self.exp_decay,
        )

    def fit(
        self,
        train: RatingsDataset,
        holdout: RatingsDataset,
        n_users: int,
        n_anime: int,
        initial_state: TrainState | None = None,
        resume: bool = False,
    ) -> TrainResult:
        """Train with early stopping; ``resume=True`` restores the latest
        checkpoint under checkpoint_dir (epoch-level resume)."""
        generator = torch.Generator().manual_seed(self.seed)
        state = initial_state or self._init_state(generator, n_users, n_anime)
        start_epoch = 0
        if resume and self.checkpoint_dir is not None and initial_state is None:
            restored = self._try_restore(state)
            if restored is not None:
                state, start_epoch = restored

        staged = self._stage_device(train, holdout) if self.device_loop else None

        ckptr = None
        if self.checkpoint_dir is not None:
            from anime_recommendations_tpu_torch.train.checkpoint import Checkpointer

            ckptr = Checkpointer(self.checkpoint_dir)

        best_val = float("inf")
        best_epoch = -1
        best = _snapshot(state.model)
        bad_epochs = 0
        rows = []
        examples_seen = 0
        t0 = time.perf_counter()

        for epoch in range(start_epoch, self.epochs):
            lr = float(np.float32(self.lr(epoch)))
            if staged is not None:
                (state, loss_sum, mse_sum, w_total,
                 val_loss, val_mse) = self._device_epoch(staged, state, epoch, lr)
            else:
                # Device scalars are kept without a host sync; they come
                # back once per epoch.
                losses, mses, bws = [], [], []
                for batch in train.iter_batches(
                    self.batch_size,
                    shuffle=self.shuffle_each_epoch,
                    seed=self.seed * 1000 + epoch,
                ):
                    state, loss, mse = self._train_step(
                        state, batch_to_device(batch, self.device), lr)
                    losses.append(loss)
                    mses.append(mse)
                    bws.append(batch.weights.sum())
                bw_arr = np.asarray(bws, np.float64)
                loss_sum = float(torch.stack(losses).cpu().numpy() @ bw_arr)
                mse_sum = float(torch.stack(mses).cpu().numpy() @ bw_arr)
                w_total = float(bw_arr.sum())
                val_loss, val_mse = self.evaluate(
                    state.model, state.model.bn_state(), holdout)
            examples_seen += int(w_total)
            rows.append(
                {
                    "loss": loss_sum / max(w_total, 1.0),
                    "mse": mse_sum / max(w_total, 1.0),
                    "val_loss": val_loss,
                    "val_mse": val_mse,
                    "lr": lr,
                }
            )
            if self.verbose:
                self.log_fn(
                    f"epoch {epoch}: loss={rows[-1]['loss']:.5f} "
                    f"mse={rows[-1]['mse']:.5f} val_loss={val_loss:.5f} "
                    f"val_mse={val_mse:.5f} lr={lr:.3g}"
                )

            # Best-state retention + early stopping (patience, min mode).
            if val_loss < best_val:
                best_val = val_loss
                best_epoch = epoch
                best = _snapshot(state.model)
                bad_epochs = 0
                if ckptr is not None:
                    ckptr.save(epoch, state)
            else:
                bad_epochs += 1
                if bad_epochs >= self.patience:
                    if self.verbose:
                        self.log_fn(f"early stop at epoch {epoch} (patience {self.patience})")
                    break

        elapsed = time.perf_counter() - t0
        # restore_best_weights=True semantics; the Adam state stays the last.
        state.model.load_state_dict(best)
        return TrainResult(
            state=state,
            history=pd.DataFrame(rows),
            best_epoch=best_epoch,
            best_val_loss=best_val,
            epochs_run=len(rows),
            examples_per_sec=examples_seen / max(elapsed, 1e-9),
        )

    # ---- device-resident epochs -------------------------------------------------

    def _stage_device(self, train: RatingsDataset, holdout: RatingsDataset):
        from anime_recommendations_tpu_torch.train import device_loop as dl

        bs = min(self.batch_size, max(len(train), 1))
        eval_bs = self._eval_batch_size(len(holdout))
        stage_seed = self.seed if self.shuffle_each_epoch else None
        return (
            dl.stage(train, bs, seed=stage_seed, device=self.device),
            dl.stage(holdout, eval_bs, device=self.device),
            bs, eval_bs,
        )

    def _device_epoch(self, staged, state, epoch: int, lr: float):
        """One staged epoch + holdout eval. Returns
        (state, loss_sum, mse_sum, w_total, val_loss, val_mse)."""
        from anime_recommendations_tpu_torch.train import device_loop as dl

        train_data, holdout_data, bs, eval_bs = staged
        generator = torch.Generator().manual_seed(self.seed * 1000 + epoch)
        state, ep_losses, ep_mses, ep_ws = dl.train_epoch(
            state, train_data, generator, lr, bs, self.l2_reg_factor,
            shuffle=self.shuffle_each_epoch,
            optimizer=self.optimizer,
        )
        bw_arr = ep_ws.cpu().numpy().astype(np.float64)
        loss_sum = float(ep_losses.cpu().numpy() @ bw_arr)
        mse_sum = float(ep_mses.cpu().numpy() @ bw_arr)
        w_total = float(bw_arr.sum())
        vl, vm = dl.eval_epoch(state.model, state.model.bn_state(), holdout_data,
                               eval_bs, self.l2_reg_factor)
        return state, loss_sum, mse_sum, w_total, float(vl), float(vm)

    def evaluate(self, model: TwoTower, bn_state: BNState,
                 ds: RatingsDataset) -> tuple[float, float]:
        loss_sum = mse_sum = w_sum = 0.0
        for batch in ds.iter_batches(self._eval_batch_size(len(ds)), shuffle=False):
            ls, ms, w = eval_step(model, bn_state, *batch_to_device(batch, self.device),
                                  self.l2_reg_factor, self.merge)
            loss_sum, mse_sum, w_sum = loss_sum + ls, mse_sum + ms, w_sum + w
        w = max(float(w_sum), 1.0)
        return float(loss_sum) / w, float(mse_sum) / w

    def _eval_batch_size(self, n_rows: int) -> int:
        return min(self.batch_size, max(n_rows, 1))

    def _try_restore(self, state: TrainState) -> tuple[TrainState, int] | None:
        from anime_recommendations_tpu_torch.train.checkpoint import Checkpointer

        ckptr = Checkpointer(self.checkpoint_dir)
        step = ckptr.latest_step()
        if step is None:
            return None
        state = ckptr.restore(state, step)
        if self.verbose:
            self.log_fn(f"resumed from checkpoint epoch {step}")
        return state, step + 1
