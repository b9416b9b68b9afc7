"""Multi-process runtime: the process group, batch feeding and the worker.

Counterpart of anime_recommendations_tpu/parallel/distributed.py. Every rank
calls ``initialize()`` before any collective; it sets up the default process
group from torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE, LOCAL_RANK): NCCL with one card per rank, or gloo with
``device="cpu"``. Data loading stays rank-local: each rank feeds only its
slice of a global batch (host_batch_slice).

    python -m torch.distributed.run --nproc_per_node=2 \\
        -m anime_recommendations_tpu_torch.parallel.distributed --worker --device cpu
    python -m torch.distributed.run --nproc_per_node=2 \\
        -m anime_recommendations_tpu_torch.parallel.distributed --worker --fit --device cpu

``--worker`` runs ``steps`` sharded train steps on random data (worker_step);
``--fit`` a full ShardedTrainer.fit with checkpoints and same-world resume
(worker_fit); ``--replay IN.npz --out OUT.npz`` runs saved states and
batches through ShardedTrainStep and the sharded epoch (worker_replay), to
hold them to another implementation's on the same inputs. Each prints one
JSON line.
"""

from __future__ import annotations

import gc
import json
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def initialize(device: str = "cuda", init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None) -> bool:
    """Initialize the default process group when running multi-process;
    returns True when a process group is active after the call.

    With no arguments it reads torchrun's environment; without WORLD_SIZE
    there (a plain single process) it does nothing. ``device``: "cuda" takes
    NCCL and this rank's card (LOCAL_RANK), "cpu" gloo."""
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" not in env:
        return False
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method,
                            world_size=world_size, rank=rank)
    logger.info("torch.distributed initialized: rank %d/%d, backend %s", rank, world_size,
                dist.get_backend())
    return True


def shutdown() -> None:
    """Destroy the default process group (if one is initialized), and with
    it every group, then collect garbage.

    The destroy drops torch's references to the groups; a group ends, and
    gloo joins its worker threads, when the port's last reference to it
    goes. A reference that only garbage in a reference cycle holds waits
    for the collector: a frame object that outlives its call (one in a
    caught exception's traceback, as importing matplotlib leaves behind)
    holds its callers' frames, so a cycle made anywhere under a training
    step keeps the step's trainer and its groups. Left to the collector's
    timing, the groups' threads may still run when the interpreter
    finalizes (parallel.mesh says how that aborts a rank); the collection
    here ends them while it runs."""
    if dist.is_initialized():
        # The cached graphs that captured the groups' collectives go first.
        from anime_recommendations_tpu_torch.train import device_loop, step_graph

        device_loop.release_graphs()
        step_graph.release_graphs()
        dist.destroy_process_group()
    gc.collect()


def host_batch_slice(global_batch: int, world=None, routing: str = "alltoall") -> slice:
    """This rank's slice of a global batch: the world's rank-th under
    "alltoall", or with ``world`` (parallel.mesh.World) and
    ``routing="psum"`` the data_index-th of data_axis slices, the same on
    every model rank of a data row (World.batch_shard). The batch must
    divide by the shards: pad a ragged one with pad_batch_for_hosts first
    (weight-0 rows are inert in every loss, metric and optimizer path)."""
    if world is not None:
        n, i = world.batch_shard(routing)
    elif dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} batch shards; "
                         "pad with pad_batch_for_hosts (zero-weight rows are inert)")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def pad_batch_for_hosts(users, anime, ratings, weights=None, n_shards: int | None = None):
    """Zero-weight-pad a global batch to a multiple of ``n_shards`` (default:
    the world size). Returns (users, anime, ratings, weights) numpy arrays;
    padded rows have weight 0, ids 0 and rating 0."""
    if n_shards is None:
        n_shards = dist.get_world_size() if dist.is_initialized() else 1
    b = len(users)
    pad = -(-b // n_shards) * n_shards - b
    if weights is None:
        weights = np.ones(b, np.float32)
    return (
        np.pad(np.asarray(users), (0, pad)),
        np.pad(np.asarray(anime), (0, pad)),
        np.pad(np.asarray(ratings, dtype=np.float32), (0, pad)),
        np.pad(np.asarray(weights, dtype=np.float32), (0, pad)),
    )


# ---- the worker -------------------------------------------------------------------


def worker_step(data_axis: int = -1, model_axis: int = 1, n_users: int = 1024,
                n_anime: int = 256, batch: int = 512, steps: int = 2,
                optimizer: str = "adam", seed: int = 0, device: str = "cuda") -> dict:
    """``steps`` sharded train steps on random data; every rank feeds only
    its slice. Returns {rank, world_size, loss, mse}: the loss and mse are
    the global batch's, equal on every rank."""
    from anime_recommendations_tpu_torch.parallel.mesh import make_world
    from anime_recommendations_tpu_torch.parallel.sharded_train import ShardedTrainStep
    from anime_recommendations_tpu_torch.parallel.trainer import init_placed_state

    world = make_world(data_axis, model_axis, device)
    state = init_placed_state(world, n_users, n_anime, 32, torch.Generator().manual_seed(seed))
    step = ShardedTrainStep(world, l2_reg_factor=1e-4, optimizer=optimizer)
    rng = np.random.default_rng(seed + 1)
    sl = host_batch_slice(batch)

    def feed(col):
        return torch.from_numpy(col[sl]).to(world.device)

    loss = mse = None
    for _ in range(steps):
        # The same stream on every rank; each keeps only its slice.
        users = rng.integers(0, n_users, batch).astype(np.int32)
        anime = rng.integers(0, n_anime, batch).astype(np.int32)
        ratings = rng.uniform(0, 1, batch).astype(np.float32)
        weights = np.ones(batch, np.float32)
        state, loss, mse = step.train_step(state, feed(users), feed(anime), feed(ratings),
                                           feed(weights), 5e-5)
    return {"rank": world.rank, "world_size": world.size, "loss": float(loss),
            "mse": float(mse)}


# The trainer settings of worker_fit, beside batch_size, epochs and optimizer.
FIT_KWARGS = dict(embedding_size=16, max_lr=5e-3, start_lr=1e-3, min_lr=1e-3, rampup_epochs=2,
                  device_loop=True, verbose=False)


def fit_data(n_users: int = 512, n_anime: int = 128, rows: int = 8192, batch: int = 512,
             seed: int = 0):
    """(train, holdout) of worker_fit: uniform random ratings from the seed."""
    from anime_recommendations_tpu_torch.data.dataset import RatingsDataset

    rng = np.random.default_rng(seed + 17)
    users = rng.integers(0, n_users, rows).astype(np.int32)
    anime = rng.integers(0, n_anime, rows).astype(np.int32)
    ratings = rng.uniform(0, 1, rows).astype(np.float32)
    cut = rows - max(rows // 8, batch)
    return (RatingsDataset(users[:cut], anime[:cut], ratings[:cut]),
            RatingsDataset(users[cut:], anime[cut:], ratings[cut:]))


def worker_fit(data_axis: int = -1, model_axis: int = 1, n_users: int = 512,
               n_anime: int = 128, rows: int = 8192, batch: int = 512, epochs: int = 3,
               optimizer: str = "fused_adam", seed: int = 0, checkpoint_dir: str | None = None,
               resume: bool = False, device: str = "cuda", capacity: int | None = None,
               routing: str = "alltoall", shard_anime: bool = False) -> dict:
    """A full ShardedTrainer.fit on every rank: the device loop (with
    planned epochs for the routed optimizers), the holdout evaluated on the
    world, best-only checkpoints per rank and, with ``resume``, a
    same-world resume. Every rank builds the
    same data from the seed (fit_data); the history is the same on every
    rank and, to reduction order, the same at any world size."""
    from anime_recommendations_tpu_torch.parallel.trainer import ShardedTrainer

    train, holdout = fit_data(n_users, n_anime, rows, batch, seed)
    trainer = ShardedTrainer(
        batch_size=batch, epochs=epochs, data_axis=data_axis, model_axis=model_axis,
        optimizer=optimizer, seed=seed, patience=max(epochs, 3), checkpoint_dir=checkpoint_dir,
        device=device, capacity=capacity, routing=routing, shard_anime=shard_anime,
        **FIT_KWARGS)
    result = trainer.fit(train, holdout, n_users, n_anime, resume=resume)
    moments = {str(v.dtype) for v in result.state.adam.mu.values()}
    return {
        "rank": trainer.world.rank,
        "world_size": trainer.world.size,
        "capacity": trainer.capacity,
        "loss": result.history["loss"].round(6).tolist(),
        "val_loss": result.history["val_loss"].round(6).tolist(),
        "best_epoch": result.best_epoch,
        "epochs_run": result.epochs_run,
        "moment_dtypes": sorted(moments),
        # Equal on every rank iff the fit and the gather of the state worked.
        "user_emb_absum": float(result.state.model.user_emb.detach().abs().sum()),
    }


def worker_replay(in_path: str, out_path: str | None, device: str = "cuda") -> dict:
    """Run saved states and batches through ShardedTrainStep. ``in_path``
    (.npz) holds ``jobs`` (JSON: a list of {name, optimizer, capacity,
    steps, state, batch, lr, l2} and optionally routing (default
    "alltoall"), shard_anime (false) and mesh ([data_axis, model_axis],
    default [world size, 1])), each named state as the keys of
    train.trainer.train_state_to_numpy under ``<state>/`` (LOGICAL order,
    split tables' rows a multiple of their shards) and each named global
    batch as
    ``<batch>/users``, ``/anime``, ``/ratings``, ``/weights``. Per job, from
    the placed state: the gradients (``<name>/grads/<param>``, logical), the
    eval sums (``<name>/eval``), then ``steps`` train steps on the batch:
    ``<name>/loss``, ``<name>/mse`` per step, the state after the first and
    the last (``<name>/step1/<key>``, ``<name>/final/<key>``, logical). A job
    with ``epoch`` = {batches, evals, order} instead runs one sharded epoch
    (sharded_train.run_epoch: planned exchanges) over the named stacked
    batches (``<batches>/users`` ... [nb, B]) in the given order, then the
    named eval batches: ``<name>/losses``, ``<name>/mses`` per step,
    ``<name>/val`` (val_loss, val_mse) and ``<name>/final/<key>``. Rank 0
    writes them to ``out_path``. Returns {rank, world_size, jobs}."""
    from anime_recommendations_tpu_torch.parallel.mesh import make_world
    from anime_recommendations_tpu_torch.parallel.sharded_train import (
        ShardedTrainStep,
        gather_table,
        place_state,
        unstripe_state,
    )
    from anime_recommendations_tpu_torch.train.trainer import (
        TABLE_KEYS,
        train_state_from_numpy,
        train_state_to_numpy,
    )

    with np.load(in_path) as z:
        arrays = {k: z[k] for k in z.files}
    jobs = json.loads(str(arrays.pop("jobs")))
    out = {}

    def group(prefix):
        return {k[len(prefix) + 1:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}

    for job in jobs:
        name = job["name"]
        routing, shard_anime = job.get("routing", "alltoall"), job.get("shard_anime", False)
        world = make_world(*job.get("mesh", (-1, 1)), device=device)
        layout = (world, routing, shard_anime)
        logical = group(job["state"])
        moments = torch.bfloat16 if job.get("bf16_moments") else torch.float32
        state = place_state(train_state_from_numpy(logical, "cpu", moments), *layout)
        step = ShardedTrainStep(world, l2_reg_factor=job["l2"], shard_anime=shard_anime,
                                routing=routing, optimizer=job["optimizer"],
                                capacity=job.get("capacity"))
        if "epoch" in job:
            out.update(_replay_epoch(job, step, state, world, layout, group))
            continue
        batch = group(job["batch"])
        sl = host_batch_slice(len(batch["users"]), world, routing)
        cols = [torch.from_numpy(np.asarray(batch[k])[sl]).to(world.device)
                for k in ("users", "anime", "ratings", "weights")]
        grads = step.grads(state, *cols)
        for k, g in grads.items():
            out[f"{name}/grads/{k}"] = (gather_table(g, world, k, routing, shard_anime)
                                        if k in TABLE_KEYS else g).detach().cpu().numpy()
        out[f"{name}/eval"] = np.array([float(x) for x in step.eval_sums(
            state.model, state.model.bn_state(), *cols)], np.float64)
        losses, mses = [], []
        for i in range(job["steps"]):
            state, loss, mse = step.train_step(state, *cols, job["lr"])
            losses.append(float(loss))
            mses.append(float(mse))
            tags = [t for t, at in (("step1", 0), ("final", job["steps"] - 1)) if i == at]
            if tags:
                logical = train_state_to_numpy(unstripe_state(state, *layout))
                out.update({f"{name}/{t}/{k}": v for t in tags for k, v in logical.items()})
        out[f"{name}/loss"] = np.array(losses, np.float64)
        out[f"{name}/mse"] = np.array(mses, np.float64)
    if out_path is not None and world.rank == 0:
        np.savez(out_path, **out)
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "jobs": [j["name"] for j in jobs]}


def _replay_epoch(job: dict, step, state, world, layout, group) -> dict:
    """One epoch job of worker_replay."""
    from anime_recommendations_tpu_torch.parallel import sharded_train as st
    from anime_recommendations_tpu_torch.train.trainer import TABLE_KEYS, train_state_to_numpy

    ep, routing = job["epoch"], layout[1]
    table_rows = tuple(getattr(state.model, k).shape[0] * world.size for k in TABLE_KEYS)

    def shards(prefix):
        b = group(prefix)
        sl = host_batch_slice(b["users"].shape[1], world, routing)
        return [torch.from_numpy(np.ascontiguousarray(np.asarray(b[k])[:, sl])).to(world.device)
                for k in ("users", "anime", "ratings", "weights")]

    train = st.plan_batches(step, shards(ep["batches"]), table_rows)
    evals = st.plan_batches(step, shards(ep["evals"]), orders=False)
    order = torch.tensor(ep["order"], dtype=torch.long) if "order" in ep else None
    losses, mses, vl, vm = st.run_epoch(step, state, job["lr"], train, evals, order)
    name = job["name"]
    out = {f"{name}/losses": losses.cpu().numpy(), f"{name}/mses": mses.cpu().numpy(),
           f"{name}/val": torch.stack([vl, vm]).cpu().numpy()}
    logical = train_state_to_numpy(st.unstripe_state(state, *layout))
    out.update({f"{name}/final/{k}": v for k, v in logical.items()})
    return out


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--fit", action="store_true",
                        help="run a full ShardedTrainer.fit instead of raw steps")
    parser.add_argument("--replay", default=None, metavar="IN.npz",
                        help="run the saved jobs of IN.npz (worker_replay)")
    parser.add_argument("--out", default=None, metavar="OUT.npz")
    parser.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    parser.add_argument("--data-axis", type=int, default=-1)
    parser.add_argument("--model-axis", type=int, default=1)
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--optimizer", default="adam")
    parser.add_argument("--capacity", type=int, default=None)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--routing", default="alltoall", choices=("alltoall", "psum"))
    parser.add_argument("--shard-anime", action="store_true",
                        help="psum: split the anime table over the model axis too")
    args = parser.parse_args(argv)
    if not args.worker:
        parser.error("nothing to do: pass --worker")

    initialize(args.device)
    try:
        if args.replay:
            out = worker_replay(args.replay, args.out, device=args.device)
        elif args.fit:
            out = worker_fit(
                args.data_axis, args.model_axis, batch=args.batch, epochs=args.epochs,
                optimizer=args.optimizer, checkpoint_dir=args.checkpoint_dir,
                resume=args.resume, device=args.device, capacity=args.capacity,
                routing=args.routing, shard_anime=args.shard_anime)
        else:
            out = worker_step(args.data_axis, args.model_axis, batch=args.batch,
                              steps=args.steps, optimizer=args.optimizer, device=args.device)
    finally:
        shutdown()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
