"""The port's ShardedTrainStep against the JAX package's, on the CPU.

The JAX side runs ``parallel.sharded_train.ShardedTrainStep`` in this
process, on the virtual CPU mesh of tests/conftest.py (m = 2: a 2 x 1 mesh,
m = 4: 2 x 2; the fused step runs its documented XLA math under shard_map).
Routing "psum" runs at the meshes of PSUM_JOBS: 2 x 1 and 1 x 2 (m = 2),
2 x 2 and 1 x 4 (m = 4), with shard_anime at 1 x 2 and 2 x 2; the port's
ranks take the same mesh (rank r = data_index * model_axis + model_index).
The port's side runs m gloo ranks of ``python -m
anime_recommendations_tpu_torch.parallel.distributed --worker --replay``,
one launch per world size for all jobs. Both start from one JAX-initialized
state, carried across as numpy, and see the same batch (some weight-0
rows) made from numpy seeds.

Tolerances, those of tests/test_torch_train.py for the same math, with
tests/test_parallel.py's for the gradients: gradients 1e-5 absolute and
1e-4 relative; loss and mse 1e-5 relative; tables and moments 1e-5 of
their largest entry; dense_w 1e-6; moving_mean 6e-5 (dense_b's Adam
rounding walk, test_torch_train.py); head moments 1e-4 relative over an
absolute floor from a gradient 1e-7 apart, (1 - b1) 1e-7 = 1e-8 for mu and
2 (1 - b2) 1e-3 1e-7 = 2e-13 for nu (gradients below 1e-3): the head's
gradients are batch sums with cancellation, dense_w's 4e-4 at m = 4, where
the two sum orders left them 4e-8 apart. Within the
port, forced multi-round overflow against the default capacity and two
paddings of one ragged batch: tests/test_parallel.py's, loss 1e-6
relative, tables 1e-6 absolute (+ 1e-5 relative).

The sharded epoch (EPOCH_JOBS): the port's sharded_train.run_epoch (plans
made on the device, every exchange run for each table's largest round
count) over 3 batches in the order EPOCH_ORDER, then 2 eval batches, against
JAX's build_epoch_fn(shuffle=False, planned=...) fed the same batches
already in that order (planned for lazy_adam and fused_adam, as JAX's
trainer runs them; adam and psum plan inside the JAX step). Tolerances:
the step jobs' above, per-step losses and mses 1e-5 relative; the eval's
(val_loss, val_mse) 2e-3 relative against JAX's epoch (tests/test_torch_train.py's
validation columns: eval-mode BatchNorm shows dense_b's rounding walk) and
1e-5 against JAX's eval sums on the port's own final state. The ranks run under a guard
(GUARD_SCRIPT) that records every host read inside the epoch body (the
steps and the eval sums): Tensor.item, tolist, __bool__, __int__,
__float__, __index__, cpu and numpy, torch.nonzero, unique, masked_select
and bincount, and indexing by a bool tensor; it must record none there,
and must record the reads of a probe run under it first.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_recommendations_tpu.models import two_tower as jtt
from anime_recommendations_tpu.parallel import routing as jrt
from anime_recommendations_tpu.parallel.mesh import make_mesh
from anime_recommendations_tpu.parallel.sharded_train import (
    ShardedTrainStep,
    build_epoch_fn,
    build_plans_fn,
    place_state,
    put_global,
    unstripe_state,
)
from anime_recommendations_tpu.train import trainer as jtr
from anime_recommendations_tpu_torch.parallel.distributed import pad_batch_for_hosts
from anime_recommendations_tpu_torch.parallel.mesh import World
from anime_recommendations_tpu_torch.parallel.sharded_train import ShardedTrainStep as PortStep
from anime_recommendations_tpu_torch.parallel.sharded_train import build_plans

REPO = Path(__file__).resolve().parents[1]
N_USERS, N_ANIME, D, B = 64, 32, 8, 64
L2, LR, STEPS = 1e-3, 1e-3, 3
WORLDS = (2, 4)
KEYS = ("user_emb", "anime_emb", "dense_w", "dense_b", "bn_gamma", "bn_beta")
TABLES = ("user_emb", "anime_emb")
# name -> (optimizer, capacity, batch, steps)
JOBS = {
    "adam": ("adam", None, "batch", STEPS),
    "lazy_adam": ("lazy_adam", None, "batch", STEPS),
    "fused_adam": ("fused_adam", None, "batch", STEPS),
    "fused_overflow": ("fused_adam", 1, "batch", STEPS),
    "padded_a": ("fused_adam", None, "padded_a", 1),
    "padded_b": ("fused_adam", None, "padded_b", 1),
}
# world size -> name -> (mesh, shard_anime): dense adam jobs with routing "psum".
PSUM_JOBS = {
    2: {"psum_2x1": ((2, 1), False), "psum_1x2": ((1, 2), False),
        "psum_anime_1x2": ((1, 2), True)},
    4: {"psum_2x2": ((2, 2), False), "psum_1x4": ((1, 4), False),
        "psum_anime_2x2": ((2, 2), True)},
}
# name -> (optimizer, capacity, routing, mesh by world size, shard_anime): the
# sharded epoch against JAX's build_epoch_fn.
EPOCH_JOBS = {
    "epoch_adam": ("adam", None, "alltoall", None, False),
    "epoch_lazy_adam": ("lazy_adam", None, "alltoall", None, False),
    "epoch_fused_adam": ("fused_adam", None, "alltoall", None, False),
    "epoch_fused_overflow": ("fused_adam", 1, "alltoall", None, False),
    "epoch_psum": ("adam", None, "psum", {2: (2, 1), 4: (2, 2)}, False),
    "epoch_psum_anime": ("adam", None, "psum", {2: (1, 2), 4: (1, 4)}, True),
}
EPOCH_ORDER = [2, 0, 1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# Runs the port's distributed worker (argv[3:]) with a guard on host reads
# inside sharded_train.epoch_body; writes what it saw to argv[2]_<rank>.json.
GUARD_SCRIPT = r'''
import functools, json, os, sys
import torch
sys.path.insert(0, sys.argv[1])
from anime_recommendations_tpu_torch.parallel import distributed, sharded_train

active, seen, calls = [False], [], [0]


def watch(owner, name):
    fn = getattr(owner, name)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if active[0]:
            seen.append(name)
        return fn(*args, **kwargs)

    setattr(owner, name, wrapped)


for name in ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "cpu", "numpy"):
    watch(torch.Tensor, name)
for name in ("nonzero", "unique", "masked_select", "bincount"):
    watch(torch, name)


def bool_index(idx):
    return any(isinstance(x, torch.Tensor) and x.dtype == torch.bool
               for x in (idx if isinstance(idx, tuple) else (idx,)))


def watch_index(name):
    fn = getattr(torch.Tensor, name)

    def wrapped(self, idx, *rest):
        if active[0] and bool_index(idx):
            seen.append("bool index")
        return fn(self, idx, *rest)

    setattr(torch.Tensor, name, wrapped)


watch_index("__getitem__")
watch_index("__setitem__")
body = sharded_train.epoch_body


def guarded(*args, **kwargs):
    calls[0] += 1
    active[0] = True
    try:
        return body(*args, **kwargs)
    finally:
        active[0] = False


sharded_train.epoch_body = guarded
active[0] = True           # the probe: a bool index and a host read
x = torch.arange(3.0)
x[x > 0].sum().item()
active[0] = False
probe, seen[:] = list(seen), []
distributed.main(sys.argv[3:])
with open(f"{sys.argv[2]}_{os.environ['RANK']}.json", "w") as f:
    json.dump({"probe": probe, "epoch_body": seen, "calls": calls[0]}, f)
'''


def launch_workers(m: int, args: list[str], timeout: int = 120,
                   guard: Path | None = None) -> list[dict]:
    """m gloo ranks of the port's distributed worker; their JSON lines.
    With ``guard`` they run under GUARD_SCRIPT, which writes what it saw to
    ``<guard>_<rank>.json``."""
    port = _free_port()
    procs = []
    for rank in range(m):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(m), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        head = (["-m", "anime_recommendations_tpu_torch.parallel.distributed"] if guard is None
                else ["-c", GUARD_SCRIPT, str(REPO), str(guard)])
        procs.append(subprocess.Popen(
            [sys.executable, *head, "--worker", "--device", "cpu", *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    return outs


def jax_to_numpy(js) -> dict:
    out = {k: np.asarray(getattr(js.params, k), np.float32) for k in KEYS}
    out["moving_mean"] = np.asarray(js.bn_state.moving_mean, np.float32)
    out["moving_var"] = np.asarray(js.bn_state.moving_var, np.float32)
    for prefix, moments in (("mu", js.opt_state.mu), ("nu", js.opt_state.nu)):
        for k in KEYS:
            out[f"{prefix}.{k}"] = np.asarray(getattr(moments, k), np.float32)
    out["count"] = np.asarray(js.opt_state.count)
    return out


def numpy_to_jax(arrays):
    params = jtt.TwoTowerParams(**{k: jnp.asarray(arrays[k]) for k in KEYS})
    bn = jtt.BNState(jnp.asarray(arrays["moving_mean"]), jnp.asarray(arrays["moving_var"]))
    moments = [jtt.TwoTowerParams(**{k: jnp.asarray(arrays[f"{p}.{k}"]) for k in KEYS})
               for p in ("mu", "nu")]
    opt = jtr.optax.ScaleByAdamState(count=jnp.asarray(arrays["count"], jnp.int32), mu=moments[0],
                                     nu=moments[1])
    return jtr.TrainState(params, bn, opt)


def batches() -> dict:
    rng = np.random.default_rng(5)
    full = (rng.integers(0, N_USERS, B).astype(np.int32),
            rng.integers(0, N_ANIME, B).astype(np.int32),
            rng.uniform(0, 1, B).astype(np.float32),
            (rng.random(B) > 0.1).astype(np.float32))           # some padding rows
    # A ragged batch of 61 padded to 64 twice: with id 0 and with row 0's ids.
    b = B - 3
    pa = pad_batch_for_hosts(full[0][:b], full[1][:b], full[2][:b], n_shards=4)
    pb = tuple(x.copy() for x in pa)
    for x, src in zip(pb[:3], full[:3]):
        x[b:] = src[0]
    return {"batch": full, "padded_a": pa, "padded_b": pb}


def epoch_batches() -> dict:
    """The epoch's 3 train batches and 2 eval batches, each column [nb, B]."""
    rng = np.random.default_rng(11)

    def stacked(nb):
        return (rng.integers(0, N_USERS, (nb, B)).astype(np.int32),
                rng.integers(0, N_ANIME, (nb, B)).astype(np.int32),
                rng.uniform(0, 1, (nb, B)).astype(np.float32),
                (rng.random((nb, B)) > 0.1).astype(np.float32))

    return {"epoch_train": stacked(3), "epoch_eval": stacked(2)}


def jax_eval(m: int, state_np: dict, routing: str, shape, shard_anime: bool) -> np.ndarray:
    """(val_loss, val_mse) of JAX's eval sums over the eval batches."""
    mesh = make_mesh(*(shape or {2: (2, 1), 4: (2, 2)}[m]), devices=jax.devices()[:m])
    step = ShardedTrainStep(mesh, l2_reg_factor=L2, shard_anime=shard_anime, routing=routing)
    st = place_state(numpy_to_jax(state_np), mesh, shard_anime, routing)
    sums = np.zeros(3)
    for cols in zip(*epoch_batches()["epoch_eval"]):
        sums += [float(x) for x in step.eval_sums(st.params, st.bn_state,
                                                   *(jnp.asarray(c) for c in cols))]
    return sums[:2] / max(sums[2], 1.0)


def jax_epoch(m: int, state_np: dict, optimizer: str, capacity, routing: str, shape,
              shard_anime: bool) -> dict:
    """JAX's build_epoch_fn(shuffle=False) over the train batches in
    EPOCH_ORDER, then the eval batches: losses, mses, (val_loss, val_mse)
    and the final state (logical)."""
    shape = shape or {2: (2, 1), 4: (2, 2)}[m]
    mesh = make_mesh(*shape, devices=jax.devices()[:m])
    step = ShardedTrainStep(mesh, l2_reg_factor=L2, shard_anime=shard_anime, routing=routing,
                            optimizer=optimizer, capacity=capacity)
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, step._baxes))
    data = epoch_batches()
    train = [put_global(x[EPOCH_ORDER], sh) for x in data["epoch_train"]]
    evals = tuple(put_global(x, sh) for x in data["epoch_eval"])
    planned = optimizer in ("lazy_adam", "fused_adam")
    extra = {}
    if planned:
        rows = (N_USERS, N_ANIME) if optimizer == "fused_adam" else None
        extra = dict(zip(("plans_u", "plans_a"), build_plans_fn(step, rows)(train[0], train[1])))
    st = place_state(numpy_to_jax(state_np), mesh, shard_anime, routing)
    st, losses, mses, _, vl, vm = build_epoch_fn(step, shuffle=False, planned=planned)(
        st, *train, evals, jax.random.PRNGKey(0), jnp.float32(LR), **extra)
    return {"losses": np.asarray(losses), "mses": np.asarray(mses),
            "val": np.array([float(vl), float(vm)]),
            "final": jax_to_numpy(unstripe_state(st, mesh, routing))}


def jax_run(m: int, state_np: dict, batch, optimizer: str, capacity, steps: int,
            routing: str = "alltoall", shape=None, shard_anime: bool = False) -> dict:
    """JAX's grads, eval sums, per-step loss/mse and states (logical)."""
    shape = shape or {2: (2, 1), 4: (2, 2)}[m]
    mesh = make_mesh(*shape, devices=jax.devices()[:m])
    step = ShardedTrainStep(mesh, l2_reg_factor=L2, shard_anime=shard_anime, routing=routing,
                            optimizer=optimizer, capacity=capacity)
    cols = [jnp.asarray(x) for x in batch]
    st = place_state(numpy_to_jax(state_np), mesh, shard_anime, routing)
    grads = step.grads(st, *cols)
    striped = routing == "alltoall"   # psum's block layout is the logical order
    out = {"grads": {k: (jrt.from_physical(np.asarray(getattr(grads, k)), m)
                         if k in TABLES and striped else np.asarray(getattr(grads, k)))
                     for k in KEYS},
           "eval": np.array([float(x) for x in step.eval_sums(st.params, st.bn_state, *cols)]),
           "loss": [], "mse": []}
    for i in range(steps):
        st, loss, mse = step.train_step(st, *cols, jnp.float32(LR))
        out["loss"].append(float(loss))
        out["mse"].append(float(mse))
        for tag, at in (("step1", 0), ("final", steps - 1)):
            if i == at:
                out[tag] = jax_to_numpy(unstripe_state(st, mesh, routing))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world size -> (port results by job, JAX results by job)."""
    tmp = tmp_path_factory.mktemp("parallel")
    state_np = jax_to_numpy(jtr.init_train_state(jax.random.PRNGKey(0), N_USERS, N_ANIME, D))
    data = batches() | epoch_batches()
    arrays = {f"init/{k}": v for k, v in state_np.items()}
    for name, cols in data.items():
        arrays.update({f"{name}/{k}": v for k, v in
                       zip(("users", "anime", "ratings", "weights"), cols)})
    jobs = [{"name": name, "optimizer": opt, "capacity": cap, "steps": steps, "state": "init",
             "batch": batch, "lr": LR, "l2": L2}
            for name, (opt, cap, batch, steps) in JOBS.items()]
    out = {}
    for m in WORLDS:
        psum = [{"name": name, "optimizer": "adam", "steps": STEPS, "state": "init",
                 "batch": "batch", "lr": LR, "l2": L2, "routing": "psum", "mesh": shape,
                 "shard_anime": shard_anime}
                for name, (shape, shard_anime) in PSUM_JOBS[m].items()]
        epochs = [{"name": name, "optimizer": opt, "capacity": cap, "state": "init", "lr": LR,
                   "l2": L2, "routing": routing, "shard_anime": shard_anime,
                   **({"mesh": meshes[m]} if meshes else {}),
                   "epoch": {"batches": "epoch_train", "evals": "epoch_eval",
                             "order": EPOCH_ORDER}}
                  for name, (opt, cap, routing, meshes, shard_anime) in EPOCH_JOBS.items()]
        np.savez(tmp / f"in{m}.npz", jobs=json.dumps(jobs + psum + epochs), **arrays)
        res = launch_workers(m, ["--replay", str(tmp / f"in{m}.npz"),
                                 "--out", str(tmp / f"out{m}.npz")], guard=tmp / f"guard{m}")
        assert [r["world_size"] for r in res] == [m] * m
        with np.load(tmp / f"out{m}.npz") as z:
            port = {k: z[k] for k in z.files}
        port["guard"] = [json.loads((tmp / f"guard{m}_{r}.json").read_text()) for r in range(m)]
        jax_res = {name: jax_run(m, state_np, data[batch], opt, cap, steps)
                   for name, (opt, cap, batch, steps) in JOBS.items() if batch == "batch"}
        jax_res.update({name: jax_run(m, state_np, data["batch"], "adam", None, STEPS, "psum",
                                      shape, shard_anime)
                        for name, (shape, shard_anime) in PSUM_JOBS[m].items()})
        jax_res.update({name: jax_epoch(m, state_np, opt, cap, routing,
                                        meshes and meshes[m], shard_anime)
                        for name, (opt, cap, routing, meshes, shard_anime) in EPOCH_JOBS.items()})
        out[m] = (port, jax_res)
    return out


def sub(port: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in port.items() if k.startswith(prefix + "/")}


def close_to_scale(got, want, rel, msg=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=msg)


def assert_states_match(got: dict, want: dict, msg: str):
    for k in ("user_emb", "anime_emb", "mu.user_emb", "mu.anime_emb", "nu.user_emb",
              "nu.anime_emb"):
        close_to_scale(got[k], want[k], 1e-5, f"{msg} {k}")
    for k, floor in (("mu.dense_w", 1e-8), ("mu.bn_gamma", 1e-8), ("nu.dense_w", 2e-13),
                     ("nu.bn_gamma", 2e-13)):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=floor, err_msg=f"{msg} {k}")
    np.testing.assert_allclose(got["dense_w"], want["dense_w"], rtol=0, atol=1e-6, err_msg=msg)
    np.testing.assert_allclose(got["moving_mean"], want["moving_mean"], rtol=0, atol=6e-5,
                               err_msg=msg)
    np.testing.assert_allclose(got["moving_var"], want["moving_var"], rtol=1e-5, err_msg=msg)
    assert int(got["count"]) == int(want["count"])


def assert_step_matches(port: dict, want: dict, job: str):
    """grads, then one and three train steps: losses, mses and states."""
    grads = sub(port, f"{job}/grads")
    for k in KEYS:
        np.testing.assert_allclose(grads[k], want["grads"][k], atol=1e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(port[f"{job}/loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(port[f"{job}/mse"], want["mse"], rtol=1e-5)
    for tag in ("step1", "final"):
        assert_states_match(sub(port, f"{job}/{tag}"), want[tag], f"{job} {tag}")


@pytest.mark.parametrize("job", ["adam", "lazy_adam", "fused_adam", "fused_overflow"])
@pytest.mark.parametrize("m", WORLDS)
def test_sharded_step_matches_jax(runs, m, job):
    port, jax_res = runs[m]
    assert_step_matches(port, jax_res[job], job)


@pytest.mark.parametrize("m,job", [(m, job) for m in WORLDS for job in PSUM_JOBS[m]])
def test_psum_step_matches_jax(runs, m, job):
    """routing="psum" (and shard_anime) on the job's data x model mesh."""
    port, jax_res = runs[m]
    assert_step_matches(port, jax_res[job], job)


@pytest.mark.parametrize("optimizer", ["lazy_adam", "fused_adam"])
def test_psum_refuses_the_routed_optimizers_as_jax_does(optimizer):
    """lazy_adam and fused_adam need the exchange plan: with routing="psum"
    both packages raise ValueError with one message; build_plans (the
    planned epoch) raises for a psum step."""
    world = World(size=1, rank=0, data_axis=1, model_axis=1, device=torch.device("cpu"))
    with pytest.raises(ValueError) as port_err:
        PortStep(world, routing="psum", optimizer=optimizer)
    with pytest.raises(ValueError) as jax_err:
        ShardedTrainStep(make_mesh(1, 1, devices=jax.devices()[:1]), routing="psum",
                         optimizer=optimizer)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="planned epoch requires routing='alltoall'"):
        build_plans(PortStep(world, routing="psum"), None, None)


@pytest.mark.parametrize("job", list(EPOCH_JOBS))
@pytest.mark.parametrize("m", WORLDS)
def test_sharded_epoch_matches_jax_build_epoch_fn(runs, m, job):
    """The port's epoch body over the batches in EPOCH_ORDER, then the eval
    batches, against JAX's build_epoch_fn fed them pre-permuted: per-step
    losses and mses, the eval's (val_loss, val_mse) and the final state."""
    port, jax_res = runs[m]
    want = jax_res[job]
    np.testing.assert_allclose(port[f"{job}/losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(port[f"{job}/mses"], want["mses"], rtol=1e-5)
    np.testing.assert_allclose(port[f"{job}/val"], want["val"], rtol=2e-3)
    assert_states_match(sub(port, f"{job}/final"), want["final"], job)
    _, _, routing, meshes, shard_anime = EPOCH_JOBS[job]
    np.testing.assert_allclose(port[f"{job}/val"], jax_eval(
        m, sub(port, f"{job}/final"), routing, meshes and meshes[m], shard_anime), rtol=1e-5)


@pytest.mark.parametrize("m", WORLDS)
def test_sharded_epoch_body_reads_nothing_on_the_host(runs, m):
    """Every rank ran every epoch job's steps and eval sums under the guard
    and it saw no host read there; its probe shows it sees them."""
    port, _ = runs[m]
    for rank, seen in enumerate(port["guard"]):
        assert "bool index" in seen["probe"] and "item" in seen["probe"], seen
        assert seen["calls"] == len(EPOCH_JOBS), seen
        assert seen["epoch_body"] == [], f"rank {rank} read on the host: {seen['epoch_body']}"


@pytest.mark.parametrize("m", WORLDS)
def test_eval_sums_match_jax(runs, m):
    port, jax_res = runs[m]
    for job in (j for j in jax_res if j not in EPOCH_JOBS):
        np.testing.assert_allclose(port[f"{job}/eval"], jax_res[job]["eval"], rtol=1e-5,
                                   err_msg=job)


@pytest.mark.parametrize("m", WORLDS)
def test_forced_overflow_equals_default_capacity(runs, m):
    """Capacity 1 runs many exchange rounds, the ones past 4 through K1's
    dense gradient: the fused step is exact under overflow."""
    port, _ = runs[m]
    per_rank = batches()["batch"][0].reshape(m, -1)
    assert max(jrt.plan_stats(jnp.asarray(s), m, 1)[2] for s in per_rank) > 4
    np.testing.assert_allclose(port["fused_overflow/loss"], port["fused_adam/loss"], rtol=1e-6)
    a, b = sub(port, "fused_overflow/final"), sub(port, "fused_adam/final")
    for k in ("user_emb", "anime_emb"):
        np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(a["nu.anime_emb"], b["nu.anime_emb"], atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("m", WORLDS)
def test_zero_weight_padded_batch_is_inert(runs, m):
    port, _ = runs[m]
    np.testing.assert_allclose(port["padded_a/loss"], port["padded_b/loss"], rtol=1e-6)
    np.testing.assert_allclose(port["padded_a/mse"], port["padded_b/mse"], rtol=1e-6)
    a, b = sub(port, "padded_a/final"), sub(port, "padded_b/final")
    np.testing.assert_allclose(a["user_emb"], b["user_emb"], atol=1e-6)
    np.testing.assert_allclose(a["nu.anime_emb"], b["nu.anime_emb"], atol=1e-7)
