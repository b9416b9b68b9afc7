"""Training epochs through the port's Trainer, the path ``cli train`` runs.

Set-up makes the ratings and the initial model from the seed (datagen.py),
builds one Trainer and one TrainState with those weights, stages the train
split and the holdout once (``Trainer._stage_device``) and captures the
epoch's graph (``device_loop.train_graph``), so that nothing is captured
inside the window. It then drives that same state through its first epoch
by the window's own call (``Trainer._device_epoch``: ``device_loop.train_epoch``,
one replay of the 699-step graph, then ``eval_epoch``) and reads what the
check compares: each step's loss, Adam's first moment and the parameters'
change after the epoch, and the holdout's loss.

The window goes on from epoch 1, whole epochs over the staged train split,
lr from ``Trainer.lr(epoch)``, until ``seconds`` have passed. After it the
port's state is freed and the reference follows the first epoch's steps
from the same inputs, in the order it works out from the seeds
(reference.epoch_batches), at the configuration's learning rate; the
learning rate of every epoch the run took is held against the
configuration's schedule.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np
import torch

from portbench import compare, datagen, reference, work
from portbench.harness import Outcome, checks_of
from portbench.trace import Tracer

LR_EPOCHS = 128     # epochs of the schedule that calibration holds against the reference's


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.detach().double()))


def _state(weights: dict, device):
    """The port's TrainState holding ``weights``, Adam's moments zero."""
    from anime_recommendations_tpu_torch.models.two_tower import PARAM_KEYS, TwoTower
    from anime_recommendations_tpu_torch.train.trainer import AdamState, TrainState

    n_users, d = weights["user_emb"].shape
    model = TwoTower(n_users, weights["anime_emb"].shape[0], d, device=device)
    with torch.no_grad():
        for k, v in weights.items():
            getattr(model, k).copy_(v)
    zeros = lambda: {k: torch.zeros_like(getattr(model, k).detach()) for k in PARAM_KEYS}
    return TrainState(model=model, adam=AdamState(count=0, mu=zeros(), nu=zeros()))


def host_data(cfg: dict, seed: int, device):
    """(train, holdout) as the port's RatingsDatasets (numpy), from the
    seeded ratings."""
    from anime_recommendations_tpu_torch.data.dataset import RatingsDataset

    r = datagen.ratings(cfg, seed, device)
    users = r.users.to(torch.int32).cpu().numpy()
    anime = r.anime.to(torch.int32).cpu().numpy()
    rating = r.rating.cpu().numpy()
    train, hold = datagen.holdout_split(len(users), cfg["test_size"], seed)
    return (RatingsDataset(users[train], anime[train], rating[train]),
            RatingsDataset(users[hold], anime[hold], rating[hold]))


def trainer_for(cfg: dict, mix: dict, seed: int, device):
    from anime_recommendations_tpu_torch.train.trainer import Trainer

    return Trainer(embedding_size=cfg["embedding_size"], l2_reg_factor=cfg["l2_reg_factor"],
                   batch_size=cfg["batch_size"], start_lr=cfg["start_lr"],
                   max_lr=cfg["max_lr"], min_lr=cfg["min_lr"],
                   rampup_epochs=cfg["rampup_epochs"], sustain_epochs=cfg["sustain_epochs"],
                   exp_decay=cfg["exp_decay"], seed=datagen.sub_seeds(seed)[6] % 2**31,
                   device_loop=True, optimizer=mix["optimizer"], device=device,
                   verbose=False)


def epoch_lr(trainer, epoch: int) -> float:
    """The learning rate the run hands epoch ``epoch``, as Trainer.fit does."""
    return float(np.float32(trainer.lr(epoch)))


@contextlib.contextmanager
def step_losses():
    """Collects the per-step losses of every device_loop.train_epoch call
    made inside the block (Trainer._device_epoch returns only their sum)."""
    from anime_recommendations_tpu_torch.train import device_loop as dl

    seen, orig = [], dl.train_epoch

    def train_epoch(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(out[1].double().cpu().tolist())
        return out

    dl.train_epoch = train_epoch
    try:
        yield seen
    finally:
        dl.train_epoch = orig


def capture(trainer, state, staged, device) -> None:
    """The epoch's graph, captured before the state takes its first step."""
    from anime_recommendations_tpu_torch.train import device_loop as dl

    if device.type == "cuda":
        dl.train_graph(state, staged[0], staged[2], trainer.l2_reg_factor,
                       trainer.shuffle_each_epoch, trainer.sorted_scatter, trainer.optimizer)
        torch.cuda.synchronize(device)


def first_epoch(trainer, state, weights: dict, staged) -> tuple:
    """Drive ``state`` from the seeded ``weights`` through epoch 0 by
    Trainer._device_epoch and read the check's numbers: (state, readings)."""
    lr = epoch_lr(trainer, 0)
    with step_losses() as seen:
        state, _, _, _, val_loss, _ = trainer._device_epoch(staged, state, 0, lr)
    model = state.model
    out = {"losses": seen[0], "lrs": [lr], "val_loss": val_loss,
           "moment_norms": {k: _norm(m.float()) for k, m in state.adam.mu.items()},
           "change_norms": {k: _norm(getattr(model, k).detach() - weights[k])
                            for k in state.adam.mu}}
    return state, out


def run_reference(cfg: dict, seed: int, trainer_seed: int, train, holdout, n_lrs: int, device,
                  dtype=torch.float32, half_batch: bool = False) -> dict:
    """The reference's readings of the first epoch, from the seed, and the
    configuration's learning rates of the first ``n_lrs`` epochs (rounded
    to ``dtype``)."""
    init = datagen.weights(cfg, seed, device)
    dev = lambda x, t: torch.as_tensor(np.asarray(x), dtype=t, device=device)
    to_dev = lambda d: (dev(d.users, torch.long), dev(d.anime, torch.long),
                        dev(d.ratings, torch.float32))
    bs = min(cfg["batch_size"], len(train))
    batches = reference.epoch_batches(len(train), bs, trainer_seed, trainer_seed * 1000)
    lrs = [float(torch.tensor(reference.lr_for_epoch(cfg, e), dtype=dtype))
           for e in range(n_lrs)]
    out = reference.train_epoch(init, to_dev(train), batches, lrs[0], cfg["l2_reg_factor"],
                                to_dev(holdout), dtype=dtype, half_batch=half_batch)
    return dict(out, lrs=lrs)


def _release(device) -> None:
    from anime_recommendations_tpu_torch.train import device_loop as dl

    dl.release_graphs()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def calibrate(cell, device, seed: int, control: bool) -> dict:
    """One seed's readings of the check's numbers, without a window: the
    sound program's first epoch against the reference (its learning rates
    over LR_EPOCHS epochs), and with ``control`` also the control's (the
    reference in bfloat16 in the program's place) and the half-batch
    fault's (the reference with half of each batch left out). A state left
    unchanged reads 1 in ``change`` and needs no run."""
    cfg, mix = cell.config, cell.traffic
    train, holdout = host_data(cfg, seed, device)
    trainer = trainer_for(cfg, mix, seed, device)
    weights = datagen.weights(cfg, seed, device)
    state = _state(weights, device)
    staged = trainer._stage_device(train, holdout)
    capture(trainer, state, staged, device)
    state, prog = first_epoch(trainer, state, weights, staged)
    prog["lrs"] = [epoch_lr(trainer, e) for e in range(LR_EPOCHS)]
    del state, staged, weights
    _release(device)
    ref = run_reference(cfg, seed, trainer.seed, train, holdout, LR_EPOCHS, device)
    out = {"sound": compare.training(prog, ref)}
    if control:
        for name, kw in (("control", {"dtype": torch.bfloat16}), ("half_batch", {"half_batch": True})):
            out[name] = compare.training(
                run_reference(cfg, seed, trainer.seed, train, holdout, LR_EPOCHS, device, **kw),
                ref)
    return out


def run(cell, device, clock) -> Outcome:
    cfg, mix, seed = cell.config, cell.traffic, cell.seed
    train, holdout = host_data(cfg, seed, device)
    clock.mark("data")
    trainer = trainer_for(cfg, mix, seed, device)
    weights = datagen.weights(cfg, seed, device)
    state = _state(weights, device)
    staged = trainer._stage_device(train, holdout)
    train_data, _, bs, _ = staged
    clock.mark("stage")
    capture(trainer, state, staged, device)
    clock.mark("capture")
    state, prog = first_epoch(trainer, state, weights, staged)
    del weights
    clock.mark("first_epoch")

    nb = train_data.n // bs
    epoch, steps, failed = 1, 0, 0
    examples = 0.0
    tracer, traced = (Tracer(device) if cell.trace else None), None
    if tracer:
        tracer.__enter__()
    t0 = time.perf_counter()
    epoch_s = []
    while True:
        lr = epoch_lr(trainer, epoch)
        prog["lrs"].append(lr)
        t_epoch = time.perf_counter()
        state, loss_sum, _, w_total, _, _ = trainer._device_epoch(staged, state, epoch, lr)
        epoch_s.append(time.perf_counter() - t_epoch)
        examples += w_total
        steps += nb
        failed += 0 if math.isfinite(loss_sum) else nb
        epoch += 1
        if tracer and traced is None:
            # The traced part is the window's first epoch.
            tracer.__exit__(None, None, None)
            traced = {"steps": steps, "epochs": len(epoch_s)}
        if time.perf_counter() - t0 >= cell.seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"[portbench] epoch seconds {[round(t, 4) for t in epoch_s]}", file=sys.stderr)

    del state, staged, train_data
    _release(device)
    t_ref = time.perf_counter()
    ref = run_reference(cfg, seed, trainer.seed, train, holdout, len(prog["lrs"]), device)
    print(f"[portbench] reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    numbers = compare.training(prog, ref)
    step = work.train_step(mix["optimizer"], cfg["n_users"], cfg["n_anime"],
                           cfg["embedding_size"], bs)
    readings = {"kind": "train", "least_step_s": step.least_seconds()}
    if traced:
        # The profiler slows the traced epoch (by a third for fused_adam's
        # short kernels): the step's wall time comes from the epochs after.
        t = tracer.trace
        untraced = epoch_s[traced["epochs"]:]
        readings.update(traced_steps=traced["steps"], device_op_s=t.op_s, busy_s=t.busy_s,
                        traced_window_s=t.window_s, device_ops=t.n_ops)
        if untraced:
            readings.update(untraced_steps=len(untraced) * nb, untraced_wall_s=sum(untraced))
    return Outcome(end_to_end={"train_examples_per_s": examples / window_s},
                   readings=readings, checks=checks_of(numbers, cell.limits),
                   attempted=steps, failed=failed, memory_peak_bytes=peak,
                   trace=tracer.trace if tracer else None)
