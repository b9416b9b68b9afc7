"""Each training and evaluation step as one graph replay (train/step_graph.py), on the CPU.

Every per-step entry point of the port runs through a StepGraphs cache whose
CUDA graph is stood in for by FakeGraph: its warm-up runs, and each replay
copies the call's inputs into the static buffers and runs the captured body
on them, so a replay that read a stale buffer (the previous batch, lr or
plan) would show. Three chained calls (the first eager, the second captured
and replayed once, the third replayed), lr changing and a new batch every
call, the batch as numpy arrays and as tensors:

  * against the JAX package's jitted counterpart fed the same numpy state
    and batches: ``train_step`` (cosine and merge="dot") and ``eval_step``
    (trainer.py), ``fused_train_step`` with f32 moments and
    ``fused_train_step_pipelined`` with and without ``kernel_gather``
    (fused.py; Pallas in interpret mode) and ``lazy_train_step`` (lazy.py),
    at the tolerances of tests/test_torch_train.py (loss and mse 2e-6
    absolute, eval sums 1e-5 relative, states its ``assert_states_match``
    at 1e-5 of each table's scale), lr at most its 1e-3; the fused steps'
    tables, moments and pipelined rows at 2e-4 of their scale,
    tests/test_torch_fused_adam.py's bound for JAX's default "fast"
    two-pass bf16 scatter against the port's exact f32 one (here JAX's K5
    rows differ from its own unfused rows by up to 1.6e-6, 3e-5 of their
    scale, where the port's are bit-equal); fused_train_step with bf16
    moments is held to JAX only through its f32 twin (JAX's stochastic
    rounding draws other bits: tests/test_torch_graph_epoch.py);
  * bit for bit against the eager body (the CPU path, StepGraphs(0)).

Every captured body runs under tests/test_torch_scan_graph.py's host-read
guard (its probe first) and must read nothing on the host. Then the cache's
policy: the key holds the state's tensors by address but not the batch's
values or addresses or lr; a state restored in place keeps its graph, a
moved one gets a new one; least recently used first out; StepGraphs(0)
keeps none. The sharded steps (ShardedTrainStep.train_step, eval_sums,
grads) run at 2 and 4 gloo ranks through the same stand-in, per step the
gradients, the eval sums and the step on a new batch at a new lr, against
JAX's ShardedTrainStep (_build_grads, _build_eval, _build_train) at
tests/test_torch_parallel.py's tolerances (the eval sums after a step at
its validation columns' 2e-3), routed (adam, lazy_adam,
fused_adam, and fused_adam at a capacity of 2 slots, many rounds: the
plans and their rounds made before each call, one host read) and psum; bit
for bit against the same calls eagerly; every body under the guard. The
captures themselves run on the card (tests/test_torch_cuda.py -k
step_graph).
"""

import json
import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_recommendations_tpu.parallel.mesh import make_mesh
from anime_recommendations_tpu.parallel.sharded_train import ShardedTrainStep as JStep
from anime_recommendations_tpu.parallel.sharded_train import place_state as jplace_state
from anime_recommendations_tpu.parallel.sharded_train import unstripe_state as junstripe_state
from anime_recommendations_tpu.parallel import routing as jrt
from anime_recommendations_tpu.train import trainer as jtr
from anime_recommendations_tpu.train.fused import fused_train_step as jfused_step
from anime_recommendations_tpu.train.fused import fused_train_step_pipelined as jfused_pipelined
from anime_recommendations_tpu.train.lazy import lazy_train_step as jlazy_step
from anime_recommendations_tpu_torch.ops import scan_graph
from anime_recommendations_tpu_torch.train import step_graph
from anime_recommendations_tpu_torch.train import trainer as tr
from anime_recommendations_tpu_torch.train.fused import (
    fused_train_step,
    fused_train_step_pipelined,
)
from anime_recommendations_tpu_torch.train.lazy import lazy_train_step

from test_torch_parallel import REPO, _free_port
from test_torch_parallel import assert_states_match as assert_sharded_states_match
from test_torch_parallel import jax_to_numpy as jax_to_numpy_sharded
from test_torch_parallel import numpy_to_jax as numpy_to_jax_sharded
from test_torch_scan_graph import host_reads  # noqa: F401 (the guard's fixture)
from test_torch_train import assert_states_match, close_to_scale, initial_arrays, numpy_to_jax

torch.set_num_threads(2)

N_USERS, N_ANIME, D, B, L2 = 300, 120, 16, 64, 1e-4
LRS = (1e-3, 5e-4, 8e-4)          # one per call, at most tests/test_torch_train.py's 1e-3
ENTRIES = ("train_cosine", "train_dot", "eval", "fused_f32", "fused_bf16", "pipelined",
           "pipelined_kernel_gather", "lazy")


def batches(seed: int) -> list[tuple[np.ndarray, ...]]:
    """len(LRS) + 1 batches (the pipelined step's next ids are the next
    batch's), the second with a quarter of its rows at weight 0."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(len(LRS) + 1):
        w = np.ones(B, np.float32)
        if i == 1:
            w[-B // 4:] = 0.0
        out.append((rng.integers(0, N_USERS, B).astype(np.int32),
                    rng.integers(0, N_ANIME, B).astype(np.int32),
                    rng.uniform(0, 1, B).astype(np.float32), w))
    return out


def as_given(cols, i):
    """Call i's columns as a caller gives them: numpy arrays, or tensors at
    the middle call."""
    return tuple(torch.from_numpy(c.copy()) for c in cols) if i == 1 else cols


# ---- the stand-in graph, and the host-read guard on every body it runs ------------

class Guard:
    """Runs a body with tests/test_torch_scan_graph.py's host-read guard on
    (``host_reads``: its Tensor methods, torch.nonzero/unique/masked_select
    and a bool-tensor index), counting the bodies."""

    def __init__(self, seen, watching):
        self.seen, self.watching, self.bodies = seen, watching, 0

    def run(self, fn):
        self.watching[0] = True
        self.bodies += 1
        try:
            return fn()
        finally:
            self.watching[0] = False


class FakeGraph:
    """CapturedGraph's interface on the CPU: the warm-up runs, and each
    replay copies the inputs into the buffers and runs the body on them,
    both under the guard."""

    guard = None

    def __init__(self, fn, warm_up, buffers, device, pool=None):
        FakeGraph.guard.run(warm_up)
        self.fn, self.buffers, self.replays = fn, buffers, 0
        self.seconds = {"warm_up": 0.0, "capture": 0.0, "instantiate": 0.0}
        self.pool_bytes, self.launches = 0, Counter()

    def replay(self, host, clone=True):
        for name, value in host.items():
            self.buffers[name].copy_(torch.from_numpy(value) if isinstance(value, np.ndarray)
                                     else value)
        self.replays += 1
        out = FakeGraph.guard.run(self.fn)
        return tuple(t.clone() for t in out) if clone else out


@pytest.fixture
def guard(host_reads):
    seen, watching = host_reads
    watching[0] = True      # the probe: a bool index and a host read
    x = torch.arange(3.0)
    x[x > 0].sum().item()
    watching[0] = False
    assert seen == ["bool index", "item"]
    seen.clear()
    return Guard(seen, watching)


@pytest.fixture
def cache(monkeypatch, guard):
    """A StepGraphs of capacity 4 that every entry point takes on the CPU,
    capturing through FakeGraph under the guard; yields (cache, guard)."""
    graphs = step_graph.StepGraphs(4)
    monkeypatch.setattr(scan_graph, "CapturedGraph", FakeGraph)
    monkeypatch.setattr(step_graph, "graphs_for", lambda device: graphs)
    monkeypatch.setattr(FakeGraph, "guard", guard)
    return graphs, guard


# ---- each entry point: through the cache, eagerly, and in JAX ----------------------

def port_state(entry, arrays):
    state = tr.train_state_from_numpy(arrays, "cpu")
    return tr.cast_table_moments(state, torch.bfloat16) if entry == "fused_bf16" else state


def port_run(entry, arrays, data):
    """The entry point's 3 chained calls from one state: per call its
    outputs (loss, mse, and the pipelined rows; the eval sums), then the
    final state's arrays."""
    state = port_state(entry, arrays)
    rows = (state.model.user_emb.detach()[torch.from_numpy(data[0][0])],
            state.model.anime_emb.detach()[torch.from_numpy(data[0][1])])
    outs = []
    for i, lr in enumerate(LRS):
        cols = as_given(data[i], i)
        if entry == "eval":
            out = tr.eval_step(state.model, state.model.bn_state(), *cols, L2)
        elif entry.startswith("train"):
            state, *out = tr.train_step(state, *cols, lr, L2, merge=entry[6:])
        elif entry.startswith("fused"):
            state, *out = fused_train_step(state, *cols, lr, L2)
        elif entry == "lazy":
            state, *out = lazy_train_step(state, *cols, lr, L2)
        else:
            nxt = as_given(data[i + 1], i)[:2]
            state, *out = fused_train_step_pipelined(
                state, *rows, *cols, *nxt, lr, L2,
                kernel_gather=entry == "pipelined_kernel_gather")
            rows = tuple(out[2:])
        outs.append([t.clone() for t in out])
    return outs, state


def jax_run(entry, arrays, data):
    """The JAX counterpart's 3 chained calls: per call its outputs as numpy,
    then the final JAX state."""
    js = numpy_to_jax(arrays)
    rows = (js.params.user_emb[data[0][0]], js.params.anime_emb[data[0][1]])
    outs = []
    for i, lr in enumerate(LRS):
        cols = tuple(map(jnp.asarray, data[i]))
        lr = jnp.float32(lr)
        if entry == "eval":
            out = jtr.eval_step(js.params, js.bn_state, *cols, L2)
        elif entry.startswith("train"):
            js, *out = jtr.train_step(js, *cols, lr, L2, merge=entry[6:])
        elif entry.startswith("fused"):
            js, *out = jfused_step(js, *cols, lr, L2)
        elif entry == "lazy":
            js, *out = jlazy_step(js, *cols, lr, L2)
        else:
            nxt = tuple(map(jnp.asarray, data[i + 1][:2]))
            js, *out = jfused_pipelined(js, *rows, *cols, *nxt, lr, L2,
                                        kernel_gather=entry == "pipelined_kernel_gather")
            rows = tuple(out[2:])
        outs.append([np.asarray(x) for x in out])
    return outs, js


def assert_bit_equal(got, want):
    (g_outs, g_state), (w_outs, w_state) = got, want
    for a, b in zip(g_outs, w_outs):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    g, w = tr.train_state_to_numpy(g_state), tr.train_state_to_numpy(w_state)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_point_through_the_cache_matches_jax_and_the_eager_body(cache, entry):
    graphs, guard = cache
    arrays = initial_arrays(N_USERS, N_ANIME, D, seed=3)
    data = batches(seed=ENTRIES.index(entry))
    got = port_run(entry, arrays, data)
    # The first call eager, the second captured (and replayed), the third replayed.
    assert (graphs.misses, graphs.captures, graphs.hits, len(graphs)) == (2, 1, 1, 1)
    (graph,) = graphs._graphs.values()
    assert graph.replays == 2
    assert guard.bodies == 3 and guard.seen == [], guard.seen
    if entry != "eval":
        assert got[1].adam.count == len(LRS)
    # Bit for bit the eager body (the CPU path, no cache).
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(step_graph, "graphs_for", lambda device: step_graph.EAGER)
        assert_bit_equal(got, port_run(entry, arrays, data))
    if entry == "fused_bf16":
        return          # held to JAX through fused_f32 (module docstring)
    want_outs, js = jax_run(entry, arrays, data)
    rel = 2e-4 if entry.startswith(("fused", "pipelined")) else 1e-5
    for outs, ref in zip(got[0], want_outs):
        if entry == "eval":
            np.testing.assert_allclose([float(x) for x in outs], [float(x) for x in ref],
                                       rtol=1e-5)
            continue
        assert abs(float(outs[0]) - float(ref[0])) < 2e-6
        assert abs(float(outs[1]) - float(ref[1])) < 2e-6
        for t, j in zip(outs[2:], ref[2:]):
            close_to_scale(t.numpy(), j, rel)
    if entry != "eval":
        assert_states_match(got[1], js, rel)


# ---- the cache's policy ------------------------------------------------------------

def _step(state, cols, lr=1e-3):
    return tr.train_step(state, *cols, lr, L2)


def test_key_holds_the_state_not_the_batch_or_lr(cache):
    graphs, _ = cache
    arrays = initial_arrays(N_USERS, N_ANIME, D, seed=1)
    data = batches(seed=7)
    state = tr.train_state_from_numpy(arrays, "cpu")
    for i, lr in enumerate(LRS):
        state, *_ = _step(state, as_given(data[i], i), lr)     # other values, addresses, lr
    assert (graphs.captures, graphs.hits, len(graphs)) == (1, 1, 1)
    # A state restored in place (a checkpoint restore copies into the same
    # tensors) keeps its graph.
    fresh = tr.train_state_from_numpy(arrays, "cpu")
    for a, b in zip(step_graph.state_tensors(state), step_graph.state_tensors(fresh)):
        a.detach().copy_(b)
    state.adam.count = 0
    state, *_ = _step(state, data[3])
    assert (graphs.captures, graphs.hits, len(graphs)) == (1, 2, 1)
    # A state whose tensors moved is a new signature: eager, then captured.
    for _ in range(2):
        fresh, *_ = _step(fresh, data[0])
    assert (graphs.captures, graphs.hits, len(graphs)) == (2, 2, 2)
    # Another batch size, merge, l2 or kind of step is another signature too.
    keys = set(graphs._graphs)
    small = tuple(c[:B // 2] for c in data[0])
    for call in (lambda: _step(fresh, small), lambda: tr.train_step(fresh, *data[0], 1e-3, 0.0),
                 lambda: tr.train_step(fresh, *data[0], 1e-3, L2, merge="dot"),
                 lambda: lazy_train_step(fresh, *data[0], 1e-3, L2)):
        call()
    assert set(graphs._graphs) == keys and len(graphs._seen) == 4


def test_least_recently_used_graphs_go_first(cache, monkeypatch):
    graphs = step_graph.StepGraphs(2)
    monkeypatch.setattr(step_graph, "graphs_for", lambda device: graphs)
    arrays = initial_arrays(N_USERS, N_ANIME, D, seed=2)
    data = batches(seed=8)
    states = [tr.train_state_from_numpy(arrays, "cpu") for _ in range(3)]
    keys = []
    for s in states:
        for _ in range(2):
            _step(s, data[0])
        keys.append(next(reversed(graphs._graphs)))
    assert list(graphs._graphs) == keys[1:] and graphs.captures == 3
    _step(states[1], data[1])              # a hit moves it to the recent end
    assert list(graphs._graphs) == [keys[2], keys[1]]
    _step(states[0], data[1])              # evicted: seen anew, eager
    assert graphs.captures == 3 and keys[0] in graphs._seen
    graphs.release()
    assert len(graphs) == 0 and not graphs._seen


def test_capacity_zero_runs_every_call_eagerly(cache, monkeypatch):
    graphs, guard = cache
    monkeypatch.setattr(step_graph, "graphs_for", lambda device: step_graph.EAGER)
    state = tr.train_state_from_numpy(initial_arrays(N_USERS, N_ANIME, D, seed=2), "cpu")
    data = batches(seed=9)
    for i in range(3):
        state, *_ = _step(state, data[i])
    assert len(step_graph.EAGER) == 0 and not step_graph.EAGER._seen
    assert step_graph.EAGER.captures == 0 and graphs.misses == 0 and guard.bodies == 0
    assert state.adam.count == 3


def test_pipelined_rows_returned_are_the_callers(cache):
    """The rows a replay returns are copies: the next replay, which takes
    them as its inputs, leaves them as they were."""
    arrays = initial_arrays(N_USERS, N_ANIME, D, seed=4)
    data = batches(seed=10)
    state = tr.train_state_from_numpy(arrays, "cpu")
    rows = (state.model.user_emb.detach()[torch.from_numpy(data[0][0])],
            state.model.anime_emb.detach()[torch.from_numpy(data[0][1])])
    kept = []
    for i in range(3):
        state, _, _, *rows = fused_train_step_pipelined(state, *rows, *data[i],
                                                        *data[i + 1][:2], 1e-3, L2)
        kept.append([(r, r.clone()) for r in rows])
    for pairs in kept:
        for r, c in pairs:
            assert torch.equal(r, c)
    buffers = next(iter(cache[0]._graphs.values())).buffers
    assert all(r.data_ptr() != b.data_ptr() for pairs in kept for r, _ in pairs
               for b in buffers.values())


def test_the_card_takes_the_shared_cache_and_the_cpu_runs_eagerly():
    assert step_graph.graphs_for("cpu") is step_graph.EAGER
    assert step_graph.graphs_for(torch.device("cuda", 0)) is step_graph.DEFAULT
    assert step_graph.DEFAULT.capacity == step_graph.STEP_GRAPH_CACHE
    assert step_graph.EAGER.capacity == 0


# ---- the sharded steps at 2 and 4 gloo ranks ----------------------------------------

WORLDS = (2, 4)
SB, S_USERS, S_ANIME, S_D, S_L2 = 64, 64, 32, 8, 1e-3
# name -> (optimizer, capacity, routing, mesh by world size)
SHARDED_JOBS = {
    "adam": ("adam", None, "alltoall", None),
    "lazy_adam": ("lazy_adam", None, "alltoall", None),
    "fused_adam": ("fused_adam", None, "alltoall", None),
    "fused_rounds": ("fused_adam", 2, "alltoall", None),
    "psum": ("adam", None, "psum", {2: (2, 1), 4: (2, 2)}),
}

# Runs argv[3:]'s jobs on this rank through a StepGraphs with the stand-in
# graph under the host-read guard (per job a new cache), then again eagerly
# (StepGraphs(0)); rank 0 writes argv[2].npz, every rank argv[2]_<rank>.json.
SHARDED_SCRIPT = r'''
import functools, json, os, sys
from collections import Counter
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from anime_recommendations_tpu_torch.ops import scan_graph
from anime_recommendations_tpu_torch.parallel import distributed
from anime_recommendations_tpu_torch.parallel.mesh import make_world
from anime_recommendations_tpu_torch.parallel.sharded_train import (
    ShardedTrainStep, gather_table, place_state, unstripe_state)
from anime_recommendations_tpu_torch.train import step_graph
from anime_recommendations_tpu_torch.train.trainer import (
    TABLE_KEYS, train_state_from_numpy, train_state_to_numpy)

active, seen, bodies = [False], [], [0]


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
getitem = torch.Tensor.__getitem__


def bool_index(t, idx):
    if active[0] and any(isinstance(x, torch.Tensor) and x.dtype == torch.bool
                         for x in (idx if isinstance(idx, tuple) else (idx,))):
        seen.append("bool index")
    return getitem(t, idx)


torch.Tensor.__getitem__ = bool_index


def guarded(fn):
    active[0] = True
    bodies[0] += 1
    try:
        return fn()
    finally:
        active[0] = False


class FakeGraph:
    def __init__(self, fn, warm_up, buffers, device, pool=None):
        guarded(warm_up)
        self.fn, self.buffers, self.replays = fn, buffers, 0
        self.seconds = {"warm_up": 0.0, "capture": 0.0, "instantiate": 0.0}

    def replay(self, host, clone=True):
        for name, value in host.items():
            self.buffers[name].copy_(torch.from_numpy(value) if isinstance(value, np.ndarray)
                                     else value)
        self.replays += 1
        return tuple(t.clone() for t in guarded(self.fn))


scan_graph.CapturedGraph = FakeGraph
active[0] = True            # the probe: a bool index and a host read
x = torch.arange(3.0)
x[x > 0].sum().item()
active[0] = False
probe, seen[:] = list(seen), []

distributed.initialize("cpu")
rank = int(os.environ["RANK"])
with np.load(sys.argv[2] + "_in.npz") as z:
    arrays = {k: z[k] for k in z.files}
jobs = json.loads(str(arrays.pop("jobs")))
out, stats = {}, {}
try:
    for job in jobs:
        for mode in ("cached", "eager"):
            graphs = step_graph.StepGraphs(4 if mode == "cached" else 0)
            step_graph.graphs_for = lambda device: graphs
            name = f"{job['name']}/{mode}"
            world = make_world(*job["mesh"], device="cpu")
            layout = (world, job["routing"], False)
            logical = {k[5:]: v for k, v in arrays.items() if k.startswith("init/")}
            state = place_state(train_state_from_numpy(logical, "cpu"), *layout)
            step = ShardedTrainStep(world, l2_reg_factor=job["l2"], routing=job["routing"],
                                    optimizer=job["optimizer"], capacity=job["capacity"])
            n, i = world.batch_shard(job["routing"])
            for s, lr in enumerate(job["lrs"]):
                cols = [arrays[f"batch{s}/{k}"].reshape(n, -1)[i]
                        for k in ("users", "anime", "ratings", "weights")]
                if s == 1:
                    cols = [torch.from_numpy(c.copy()) for c in cols]
                grads = step.grads(state, *cols)
                for k, g in grads.items():
                    out[f"{name}/grads{s}/{k}"] = (gather_table(g, *layout[:1], k, job["routing"])
                                                   if k in TABLE_KEYS else g).numpy()
                out[f"{name}/eval{s}"] = torch.stack(step.eval_sums(
                    state.model, state.model.bn_state(), *cols)).double().numpy()
                state, loss, mse = step.train_step(state, *cols, lr)
                out[f"{name}/loss{s}"] = np.array([float(loss), float(mse)])
            final = train_state_to_numpy(unstripe_state(state, *layout))
            out.update({f"{name}/final/{k}": v for k, v in final.items()})
            stats[name] = {"captures": graphs.captures, "hits": graphs.hits,
                           "misses": graphs.misses, "graphs": len(graphs),
                           "replays": sorted(g.replays for g in graphs._graphs.values())}
finally:
    distributed.shutdown()
if rank == 0:
    np.savez(sys.argv[2] + "_out.npz", **out)
with open(f"{sys.argv[2]}_{rank}.json", "w") as f:
    json.dump({"probe": probe, "seen": seen, "bodies": bodies[0], "stats": stats}, f)
print(json.dumps({"rank": rank, "world_size": world.size}))
'''


def sharded_batches() -> list[tuple[np.ndarray, ...]]:
    """One batch per step. Each 16-row block of a batch's ids (a shard at
    4 ranks, half of one at 2) is a permutation of the first batch's, so
    every batch takes the same exchange rounds at either world size (one
    graph per kind of call) with other plans, ratings and weights."""
    rng = np.random.default_rng(12)
    users = rng.integers(0, S_USERS, SB).astype(np.int32)
    anime = rng.integers(0, S_ANIME, SB).astype(np.int32)

    def shuffled(ids):
        return np.concatenate([rng.permutation(block) for block in ids.reshape(-1, 16)])

    return [(shuffled(users), shuffled(anime), rng.uniform(0, 1, SB).astype(np.float32),
             (rng.random(SB) > 0.1).astype(np.float32)) for _ in LRS]


def launch_script(m: int, args: list[str], timeout: int = 300) -> list[dict]:
    """m gloo ranks of SHARDED_SCRIPT with ``args``; their JSON lines."""
    port = _free_port()
    procs = []
    for rank in range(m):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(m), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", SHARDED_SCRIPT, *args], cwd=REPO,
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    return outs


def jax_sharded(m, state_np, optimizer, capacity, routing, shape) -> dict:
    """JAX's grads, eval sums and step on each batch in turn, per step, and
    the final state (logical)."""
    mesh = make_mesh(*(shape or {2: (2, 1), 4: (2, 2)}[m]), devices=jax.devices()[:m])
    step = JStep(mesh, l2_reg_factor=S_L2, routing=routing, optimizer=optimizer,
                 capacity=capacity)
    st = jplace_state(numpy_to_jax_sharded(state_np), mesh, False, routing)
    out = {}
    for s, (cols, lr) in enumerate(zip(sharded_batches(), LRS)):
        cols = [jnp.asarray(c) for c in cols]
        grads = step.grads(st, *cols)
        out[f"grads{s}"] = {k: (jrt.from_physical(np.asarray(getattr(grads, k)), m)
                                if k in tr.TABLE_KEYS and routing == "alltoall"
                                else np.asarray(getattr(grads, k))) for k in tr.PARAM_KEYS}
        out[f"eval{s}"] = np.array([float(x) for x in step.eval_sums(st.params, st.bn_state,
                                                                      *cols)])
        st, loss, mse = step.train_step(st, *cols, jnp.float32(lr))
        out[f"loss{s}"] = np.array([float(loss), float(mse)])
    out["final"] = jax_to_numpy_sharded(junstripe_state(st, mesh, routing))
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """world size -> (the ranks' arrays, their guard records, JAX by job)."""
    tmp = tmp_path_factory.mktemp("step_graph")
    state_np = jax_to_numpy_sharded(jtr.init_train_state(jax.random.PRNGKey(1), S_USERS,
                                                         S_ANIME, S_D))
    arrays = {f"init/{k}": v for k, v in state_np.items()}
    for s, cols in enumerate(sharded_batches()):
        arrays.update({f"batch{s}/{k}": v for k, v in
                       zip(("users", "anime", "ratings", "weights"), cols)})
    out = {}
    for m in WORLDS:
        jobs = [{"name": name, "optimizer": opt, "capacity": cap, "routing": routing,
                 "mesh": list(meshes[m]) if meshes else [m, 1], "lrs": list(LRS), "l2": S_L2}
                for name, (opt, cap, routing, meshes) in SHARDED_JOBS.items()]
        base = tmp / f"w{m}"
        np.savez(f"{base}_in.npz", jobs=json.dumps(jobs), **arrays)
        res = launch_script(m, [str(REPO), str(base)])
        assert sorted(r["rank"] for r in res) == list(range(m))
        with np.load(f"{base}_out.npz") as z:
            port = {k: z[k] for k in z.files}
        ranks = [json.loads((tmp / f"w{m}_{r}.json").read_text()) for r in range(m)]
        want = {name: jax_sharded(m, state_np, opt, cap, routing, meshes and meshes[m])
                for name, (opt, cap, routing, meshes) in SHARDED_JOBS.items()}
        out[m] = (port, ranks, want)
    return out


def sub(port: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in port.items() if k.startswith(prefix + "/")}


@pytest.mark.parametrize("job", list(SHARDED_JOBS))
@pytest.mark.parametrize("m", WORLDS)
def test_sharded_steps_through_the_cache_match_jax_and_the_eager_steps(sharded, m, job):
    """Per step grads, eval sums and the train step through the cache:
    against JAX's at tests/test_torch_parallel.py's tolerances, and bit for
    bit the same calls eagerly; each kind captured at its second call and
    replayed at the second and third."""
    port, ranks, want = sharded[m]
    cached, eager = sub(port, f"{job}/cached"), sub(port, f"{job}/eager")
    assert set(cached) == set(eager)
    for k in eager:
        np.testing.assert_array_equal(cached[k], eager[k], err_msg=k)
    ref = want[job]
    for s in range(len(LRS)):
        grads = sub(cached, f"grads{s}")
        for k in tr.PARAM_KEYS:
            np.testing.assert_allclose(grads[k], ref[f"grads{s}"][k], atol=1e-5, rtol=1e-4,
                                       err_msg=f"step {s} {k}")
        # After a step, eval-mode BatchNorm shows dense_b's rounding walk:
        # the validation columns' 2e-3 (tests/test_torch_parallel.py).
        np.testing.assert_allclose(cached[f"eval{s}"], ref[f"eval{s}"], rtol=2e-3 if s else 1e-5)
        np.testing.assert_allclose(cached[f"loss{s}"], ref[f"loss{s}"], rtol=1e-5)
    assert_sharded_states_match(sub(cached, "final"), ref["final"], job)
    # Each kind of call captured at its second call and replayed at its
    # third; a routed step's plans (ShardedTrainStep.make_plans, before
    # each of the 9 calls) a graph of their own.
    want_stats = ({"captures": 3, "hits": 3, "misses": 6, "graphs": 3, "replays": [2, 2, 2]}
                  if SHARDED_JOBS[job][2] == "psum" else
                  {"captures": 4, "hits": 10, "misses": 8, "graphs": 4, "replays": [2, 2, 2, 8]})
    for r in ranks:
        assert r["stats"][f"{job}/cached"] == want_stats, r["stats"][f"{job}/cached"]
        assert r["stats"][f"{job}/eager"]["captures"] == 0


@pytest.mark.parametrize("m", WORLDS)
def test_sharded_bodies_read_nothing_on_the_host(sharded, m):
    """Every captured sharded body (warm-ups and replays of every job, the
    routed steps at many rounds included) ran under the guard and it saw
    no host read; its probe shows it sees them."""
    _, ranks, _ = sharded[m]
    for rank, r in enumerate(ranks):
        assert "bool index" in r["probe"] and "item" in r["probe"], r["probe"]
        # Per job a warm-up and two replays of each kind of call, and of a
        # routed step's plans a warm-up and 8 replays.
        routed = sum(job[2] == "alltoall" for job in SHARDED_JOBS.values())
        assert r["bodies"] == 9 * len(SHARDED_JOBS) + 9 * routed, r["bodies"]
        assert r["seen"] == [], f"rank {rank} read on the host: {r['seen']}"


def test_many_rounds_case_takes_more_than_four_rounds():
    """fused_rounds' capacity makes every batch take more than one exchange
    round on both tables and more than 4 on the user table (K1's dense
    branch), every batch the same rounds at either world size."""
    for m in WORLDS:
        rounds = {tuple(max(int(jrt.plan_stats(jnp.asarray(s), m, 2)[2]) for s in ids.reshape(m, -1))
                        for ids in b[:2]) for b in sharded_batches()}
        (per_table,) = rounds
        assert min(per_table) > 1 and per_table[0] > 4, per_table
