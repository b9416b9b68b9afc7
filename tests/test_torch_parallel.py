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
    place_state,
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_workers(m: int, args: list[str], timeout: int = 120) -> list[dict]:
    """m gloo ranks of the port's distributed worker; their JSON lines."""
    port = _free_port()
    procs = []
    for rank in range(m):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(m), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "anime_recommendations_tpu_torch.parallel.distributed",
             "--worker", "--device", "cpu", *args],
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
    data = batches()
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
        np.savez(tmp / f"in{m}.npz", jobs=json.dumps(jobs + psum), **arrays)
        res = launch_workers(m, ["--replay", str(tmp / f"in{m}.npz"),
                                 "--out", str(tmp / f"out{m}.npz")])
        assert [r["world_size"] for r in res] == [m] * m
        with np.load(tmp / f"out{m}.npz") as z:
            port = {k: z[k] for k in z.files}
        jax_res = {name: jax_run(m, state_np, data[batch], opt, cap, steps)
                   for name, (opt, cap, batch, steps) in JOBS.items() if batch == "batch"}
        jax_res.update({name: jax_run(m, state_np, data["batch"], "adam", None, STEPS, "psum",
                                      shape, shard_anime)
                        for name, (shape, shard_anime) in PSUM_JOBS[m].items()})
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


@pytest.mark.parametrize("m", WORLDS)
def test_eval_sums_match_jax(runs, m):
    port, jax_res = runs[m]
    for job in jax_res:
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
