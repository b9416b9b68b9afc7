"""Training epochs of row-sparse Adam (``lazy_adam``) through the port's
Trainer, epochs long enough that the device loop runs each as chunks.

The set-up, window and check of train_epochs (its helpers, through
harness.kind_module), with what the chunked loop and the row-sparse
optimizer change:

* set-up captures every graph an epoch replays (``device_loop.epoch_graphs``:
  the chunk's and the tail's) and drives the state through epoch 0; the
  window goes on from epoch 1;
* the check holds the first epoch against reference_lazy.py (row-sparse
  Adam, no L2 term in a step's loss) and counts the epoch graphs captured
  inside the window (``device_loop.graph_report``), which must be none;
* the traced epoch (the window's first) runs with the program's span
  recorder on, and the host's gaps between its ``epoch.chunk`` spans are
  read (``chunk_gap_ms.train``);
* a step's least time counts the rows the step's batch touches, unique users
  plus unique items, worked out on the device from the seeded batch order
  of the epoch the reference follows, averaged over its steps.

A port whose device loop has no chunked epochs fails at once: capturing an
8,759-step epoch as one graph would take minutes.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from portbench import compare, datagen, harness, reference, reference_lazy, work
from portbench.harness import Outcome, checks_of
from portbench.trace import Tracer

base = harness.kind_module("train_epochs")
CHUNKED = ("chunks", "epoch_graphs", "graph_report")   # what the device loop must have


def device_loop():
    """The port's device loop, if it runs long epochs in chunks; raises
    naming what is missing otherwise."""
    from anime_recommendations_tpu_torch.train import device_loop as dl

    missing = [name for name in CHUNKED if not hasattr(dl, name)]
    if missing:
        raise RuntimeError(f"the port's device loop has no chunked epochs "
                           f"(device_loop lacks {', '.join(missing)}): this cell's epochs "
                           f"would be captured as one graph")
    return dl


def capture(trainer, state, staged, device) -> None:
    """Every graph of the epoch (chunk and tail), before the state's first
    step."""
    dl = device_loop()
    if device.type == "cuda":
        dl.epoch_graphs(state, staged[0], staged[2], trainer.l2_reg_factor,
                        trainer.shuffle_each_epoch, trainer.sorted_scatter, trainer.optimizer)
        torch.cuda.synchronize(device)


def touched_rows(train, batches: list, batch_size: int, device) -> float:
    """The mean over the epoch's steps of the table rows a step's lazy update
    touches: its batch's unique users plus unique items, row 0 of both
    tables counted for a padded batch (reference_lazy's rule)."""
    lengths = np.array([len(b) for b in batches], np.int64)
    idx = torch.from_numpy(np.concatenate(batches)).to(device)
    step = torch.repeat_interleave(torch.arange(len(batches), device=device),
                                   torch.from_numpy(lengths).to(device))
    padded = torch.from_numpy(np.flatnonzero(lengths < batch_size)).to(device)
    total = 0
    for col in (train.users, train.anime):
        ids = torch.from_numpy(np.asarray(col, np.int64)).to(device)[idx]
        n = int(ids.max()) + 1
        keys = torch.cat([step * n + ids, padded * n])
        total += len(torch.unique(keys))
        del ids, keys
    return total / len(batches)


def run_reference(cfg: dict, seed: int, trainer_seed: int, train, holdout, n_lrs: int, device,
                  dtype=torch.float32, half_batch: bool = False, dense: bool = False,
                  with_touched: bool = False) -> dict:
    """The reference's readings of the first epoch (reference_lazy, or with
    ``dense`` the dense-Adam reference in its place: a fault), the
    configuration's learning rates of the first ``n_lrs`` epochs, and with
    ``with_touched`` the epoch's mean touched rows a step."""
    init = datagen.weights(cfg, seed, device)
    dev = lambda x, t: torch.as_tensor(np.asarray(x), dtype=t, device=device)
    to_dev = lambda d: (dev(d.users, torch.long), dev(d.anime, torch.long),
                        dev(d.ratings, torch.float32))
    bs = min(cfg["batch_size"], len(train))
    batches = reference.epoch_batches(len(train), bs, trainer_seed, trainer_seed * 1000)
    lrs = [float(torch.tensor(reference.lr_for_epoch(cfg, e), dtype=dtype))
           for e in range(n_lrs)]
    if dense:
        out = reference.train_epoch(init, to_dev(train), batches, lrs[0], cfg["l2_reg_factor"],
                                    to_dev(holdout), dtype=dtype, half_batch=half_batch)
    else:
        out = reference_lazy.train_epoch(init, to_dev(train), batches, lrs[0],
                                         cfg["l2_reg_factor"], to_dev(holdout), bs, dtype=dtype,
                                         half_batch=half_batch)
    out["lrs"] = lrs
    if with_touched:
        del init
        t0 = time.perf_counter()
        out["touched_rows"] = touched_rows(train, batches, bs, device)
        out["touched_s"] = time.perf_counter() - t0
    return out


def _setup(cell, seed: int, device, clock=None):
    """Set-up as train_epochs' run does it, capturing the chunked graphs:
    (train, holdout, trainer, state, staged, first epoch's readings)."""
    mark = clock.mark if clock else (lambda name: None)
    cfg, mix = cell.config, cell.traffic
    train, holdout = base.host_data(cfg, seed, device)
    mark("data")
    trainer = base.trainer_for(cfg, mix, seed, device)
    weights = datagen.weights(cfg, seed, device)
    state = base._state(weights, device)
    staged = trainer._stage_device(train, holdout)
    mark("stage")
    capture(trainer, state, staged, device)
    mark("capture")
    state, prog = base.first_epoch(trainer, state, weights, staged)
    mark("first_epoch")
    return train, holdout, trainer, state, staged, prog


def calibrate(cell, device, seed: int, control: bool) -> dict:
    """One seed's readings of the check's numbers, without a window (no
    graph can be captured inside one: ``window_captures`` reads 0): the
    sound program's first epoch against reference_lazy, and with
    ``control`` the control's (reference_lazy in bfloat16 in the program's
    place), the half-batch fault's and the dense-semantics fault's (the
    dense-Adam reference in the program's place)."""
    device_loop()
    cfg = cell.config
    train, holdout, trainer, state, staged, prog = _setup(cell, seed, device)
    prog["lrs"] = [base.epoch_lr(trainer, e) for e in range(base.LR_EPOCHS)]
    del state, staged
    base._release(device)
    args = (cfg, seed, trainer.seed, train, holdout, base.LR_EPOCHS, device)
    ref = run_reference(*args)
    numbers = lambda got: dict(compare.training(got, ref), window_captures=0)
    out = {"sound": numbers(prog)}
    if control:
        for name, kw in (("control", {"dtype": torch.bfloat16}),
                         ("half_batch", {"half_batch": True}), ("dense", {"dense": True})):
            out[name] = numbers(run_reference(*args, **kw))
    return out


def run(cell, device, clock) -> Outcome:
    dl = device_loop()
    from anime_recommendations_tpu_torch.utils import profiling

    cfg, mix, seed = cell.config, cell.traffic, cell.seed
    train, holdout, trainer, state, staged, prog = _setup(cell, seed, device, clock)
    train_data, _, bs, _ = staged
    captured = dl.graph_report()["captured"]

    nb = train_data.n // bs
    epoch, steps, failed = 1, 0, 0
    examples = 0.0
    tracer, traced = (Tracer(device) if cell.trace else None), None
    if tracer:
        profiling.spans_start()
        tracer.__enter__()
    t0 = time.perf_counter()
    epoch_s = []
    while True:
        lr = base.epoch_lr(trainer, epoch)
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
            traced = {"steps": steps, "epochs": len(epoch_s), "spans": profiling.spans_stop()}
        # A traced run goes on to an untraced epoch: the step's wall time
        # (train_step_mfu) comes from the epochs after the profiler closed,
        # and closing it on a long epoch can outlast the window.
        after_trace = len(epoch_s) - (traced["epochs"] if traced else 0)
        if time.perf_counter() - t0 >= cell.seconds and after_trace > 0:
            break
    window_s = time.perf_counter() - t0
    window_captures = dl.graph_report()["captured"] - captured
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"[portbench] epoch seconds {[round(t, 4) for t in epoch_s]}; "
          f"graphs {dl.graph_report()}", file=sys.stderr)

    del state, staged, train_data
    base._release(device)
    t_ref = time.perf_counter()
    ref = run_reference(cfg, seed, trainer.seed, train, holdout, len(prog["lrs"]), device,
                        with_touched=True)
    print(f"[portbench] reference {time.perf_counter() - t_ref:.3f} s, of which touched rows "
          f"{ref['touched_s']:.3f} s: {ref['touched_rows']} a step", file=sys.stderr)
    numbers = dict(compare.training(prog, ref), window_captures=window_captures)
    step = work.train_step(mix["optimizer"], cfg["n_users"], cfg["n_anime"],
                           cfg["embedding_size"], bs, touched_rows=ref["touched_rows"])
    readings = {"kind": "train", "least_step_s": step.least_seconds()}
    if traced:
        t = tracer.trace
        untraced = epoch_s[traced["epochs"]:]
        readings.update(traced_steps=traced["steps"], device_op_s=t.op_s, busy_s=t.busy_s,
                        traced_window_s=t.window_s, device_ops=t.n_ops,
                        **chunk_gaps(traced["spans"]))
        if untraced:
            readings.update(untraced_steps=len(untraced) * nb, untraced_wall_s=sum(untraced))
    return Outcome(end_to_end={"train_examples_per_s": examples / window_s},
                   readings=readings, checks=checks_of(numbers, cell.limits),
                   attempted=steps, failed=failed, memory_peak_bytes=peak,
                   trace=tracer.trace if tracer else None)


def chunk_gaps(spans) -> dict:
    """The host's seconds between one ``epoch.chunk`` span's end and the
    next one's start within an epoch (spans of one root): their sum and
    count."""
    ends: dict = {}
    gap_s, gaps = 0.0, 0
    for s in spans:
        if s.name != "epoch.chunk" or s.end_ns is None:
            continue
        if s.root in ends:
            gap_s += (s.start_ns - ends[s.root]) / 1e9
            gaps += 1
        ends[s.root] = s.end_ns
    return {"chunk_gap_s": gap_s, "chunk_gaps": gaps}
