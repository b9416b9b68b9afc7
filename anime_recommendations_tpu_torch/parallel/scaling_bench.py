"""Scaling-efficiency harness: training examples/s per mesh shape.

Counterpart of anime_recommendations_tpu/parallel/scaling_bench.py, with
its flags and output keys. For each mesh shape ``DxM`` it starts one
``torch.distributed.run`` launch of D*M ranks (gloo with ``--device cpu``,
NCCL with one card per rank with ``--device cuda``), times ``--steps``
ShardedTrainStep steps after 3 warm-up steps on rank 0's clock, and prints
one JSON line per mesh, then a ``summary`` line with each mesh's parallel
efficiency relative to the first.

    python -m anime_recommendations_tpu_torch.parallel.scaling_bench \\
        --device cpu --meshes 1x1 2x1 --steps 30 --batch 8192

A mesh that needs more cards than are visible raises; there is no fallback
to the CPU. On the CPU the numbers validate the collectives' structure, not
an interconnect's bandwidth.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def measure_mesh(
    data_axis: int,
    model_axis: int,
    n_users: int,
    n_anime: int,
    embedding_size: int,
    batch: int,
    steps: int,
    seed: int = 0,
    routing: str = "alltoall",
    optimizer: str = "adam",
    device=None,
) -> dict:
    """Examples/s of ``steps`` train steps on a ``data_axis`` x
    ``model_axis`` mesh; every rank of an initialized process group calls
    it (parallel.distributed.initialize). Each rank feeds its slice of 4
    random global batches from ``seed`` in turn. Raises if the last loss is
    not finite."""
    from anime_recommendations_tpu_torch.parallel.distributed import host_batch_slice
    from anime_recommendations_tpu_torch.parallel.mesh import make_world
    from anime_recommendations_tpu_torch.parallel.sharded_train import ShardedTrainStep
    from anime_recommendations_tpu_torch.parallel.trainer import init_placed_state

    world = make_world(data_axis, model_axis, device)
    step = ShardedTrainStep(world, l2_reg_factor=1e-4, routing=routing, optimizer=optimizer)
    state = init_placed_state(world, n_users, n_anime, embedding_size,
                              torch.Generator().manual_seed(seed), routing=routing)
    rng = np.random.default_rng(seed)
    sl = host_batch_slice(batch, world, routing)
    n_batches = 4
    batches = [
        tuple(torch.from_numpy(col[sl]).to(world.device) for col in (
            rng.integers(0, n_users, batch).astype(np.int32),
            rng.integers(0, n_anime, batch).astype(np.int32),
            rng.uniform(0, 1, batch).astype(np.float32),
            np.ones(batch, np.float32)))
        for _ in range(n_batches)
    ]
    lr = 5e-5

    def run(state, n):
        loss = None
        for i in range(n):
            state, loss, _ = step.train_step(state, *batches[i % n_batches], lr)
        return state, loss

    state, loss = run(state, 3)  # warm-up
    float(loss)
    t0 = time.perf_counter()
    state, loss = run(state, steps)
    loss = float(loss)
    dt = time.perf_counter() - t0
    if not math.isfinite(loss):
        raise FloatingPointError(f"mesh {data_axis}x{model_axis}: non-finite loss {loss}")
    return {
        "mesh": f"{data_axis}x{model_axis}",
        "devices": world.size,
        "routing": routing,
        "optimizer": optimizer,
        "examples_per_sec": steps * batch / dt,
        "step_ms": dt / steps * 1e3,
    }


def _launch(args, data_axis: int, model_axis: int, batch: int) -> dict:
    """One torch.distributed.run launch of this module's worker on a mesh;
    rank 0's result line."""
    n = data_axis * model_axis
    if args.device == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"mesh {data_axis}x{model_axis} needs {n} cards; "
                           f"{torch.cuda.device_count()} visible")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", "-m", "anime_recommendations_tpu_torch.parallel.scaling_bench",
           "--worker",
           "--meshes", f"{data_axis}x{model_axis}", "--batch", str(batch),
           "--steps", str(args.steps), "--users", str(args.users), "--anime", str(args.anime),
           "--emb", str(args.emb), "--routing", args.routing, "--optimizer", args.optimizer,
           "--device", args.device]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          cwd=Path(__file__).resolve().parents[2])
    if proc.returncode:
        raise RuntimeError(f"mesh {data_axis}x{model_axis} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _worker(args) -> None:
    """One rank of a launch: measure its mesh, rank 0 prints the result."""
    import torch.distributed as dist

    from anime_recommendations_tpu_torch.parallel.distributed import initialize, shutdown

    initialize(args.device)
    try:
        d, m = (int(x) for x in args.meshes[0].split("x"))
        res = measure_mesh(d, m, args.users, args.anime, args.emb, args.batch, args.steps,
                           routing=args.routing, optimizer=args.optimizer, device=args.device)
        rank = dist.get_rank()
    finally:
        shutdown()
    if rank == 0:
        print(json.dumps(res), flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--meshes", nargs="+", default=["1x1", "2x1", "4x1", "4x2"])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch", type=int, default=8192)
    parser.add_argument("--users", type=int, default=91_641)
    parser.add_argument("--anime", type=int, default=17_560)
    parser.add_argument("--emb", type=int, default=128)
    parser.add_argument("--routing", choices=["alltoall", "psum"], default="alltoall")
    parser.add_argument("--optimizer", choices=["adam", "lazy_adam", "fused_adam"],
                        default="adam")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda: NCCL, one card per rank; cpu: gloo")
    parser.add_argument("--weak", action="store_true",
                        help="weak scaling: global batch = --batch * devices "
                             "(the reference's num_replicas_in_sync scaling, "
                             "neural_network.py:176-177)")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        _worker(args)
        return
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card visible")

    results = []
    for shape in args.meshes:
        d, m = (int(x) for x in shape.split("x"))
        batch = args.batch * (d * m if args.weak else 1)
        res = _launch(args, d, m, batch)
        results.append(res)
        print(json.dumps(res), flush=True)

    base = results[0]
    for res in results:
        scale = res["devices"] / base["devices"]
        ideal = base["examples_per_sec"] * scale
        res["efficiency_vs_first"] = res["examples_per_sec"] / ideal
    print(
        json.dumps(
            {
                "summary": [
                    {
                        "mesh": r["mesh"],
                        "examples_per_sec": round(r["examples_per_sec"]),
                        "efficiency": round(r["efficiency_vs_first"], 3),
                    }
                    for r in results
                ]
            }
        )
    )


if __name__ == "__main__":
    main()
