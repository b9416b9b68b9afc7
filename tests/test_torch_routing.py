"""The port's all-to-all row routing against the JAX package's, on the CPU.

The port's side runs in m gloo ranks (separate processes, one launch per
world size for all cases); the JAX side runs the same functions under
shard_map on the virtual CPU mesh of tests/conftest.py, with rank r as the
mesh's flat index r. Inputs come from numpy seeds: the cases of
tests/test_routing.py (duplicates, one hot owner over many rounds, ids
past the table), at m = 1, 2 and 4. Gathered rows are equal; table
gradients, staged receipts and dense overflow within 1e-6 (the two sum
duplicates in another order); receipt ids, round counts, served rows and
plan statistics equal.

Padded rounds, at m = 2 and 4 (the port alone): a sharded epoch runs every
exchange for the largest round count of its batches. Each rank steps
PADDED_BATCHES with every optimizer (adam, lazy_adam, fused_adam,
fused_adam_bf16m) at capacity 1, where the batches take from 1 to more
than 4 rounds, once with each batch's plans at its own round count and once
at the epoch's largest count plus one: losses, mses, eval sums and every
state tensor must be bit-equal.
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
from jax.sharding import PartitionSpec as P

from anime_recommendations_tpu.parallel import routing as jrt
from anime_recommendations_tpu.parallel.mesh import make_mesh
from anime_recommendations_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for
from anime_recommendations_tpu_torch.parallel import mesh as tmesh
from anime_recommendations_tpu_torch.parallel import routing as rt

REPO = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
WORLDS = (1, 2, 4)
TIMEOUT = 120

# Each rank runs every case of the spec on its shard and saves its results.
RANK_SCRIPT = r'''
import json, sys
import numpy as np, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[3])
from anime_recommendations_tpu_torch.parallel import routing as rt

torch.set_num_threads(1)
dist.init_process_group("gloo")
m, r = dist.get_world_size(), dist.get_rank()
z = np.load(sys.argv[1])
out = {}
for case in json.loads(str(z["spec"])):
    name, cap = case["name"], case["capacity"]
    if name + "/ids" in z.files:
        ids = torch.from_numpy(z[name + "/ids"]).view(m, -1)[r]
    if case["kind"] == "exchange":
        table = torch.from_numpy(z[name + "/table"])[r::m].clone().requires_grad_()
        rows = rt.exchange_rows(table, ids, n_shards=m, capacity=cap)
        cot = torch.from_numpy(z[name + "/cot"]).view(m, -1, table.shape[1])[r]
        (grad,) = torch.autograd.grad((rows * cot).sum(), table)
        out[name + "/rows"], out[name + "/grad"] = rows.detach().numpy(), grad.numpy()
        out[name + "/rounds"] = np.array(rt.make_plan(ids, m, cap).rounds)
    elif case["kind"] == "route":
        g = torch.from_numpy(z[name + "/g"]).view(m, -1, case["d"])[r]
        kw = dict(n_shards=m, capacity=cap, r_local=case["rows"] // m,
                  staged_rounds=case["staged_rounds"])
        oid, og, dense = rt.route_grad_rows(ids, g, **kw)
        out[name + "/oid"], out[name + "/og"] = oid.numpy(), og.numpy()
        if dense is not None:
            out[name + "/dense"] = dense.numpy()
        out[name + "/order"] = rt.receipt_sort_order(ids, **kw).numpy()
    elif case["kind"] == "received":
        table = torch.from_numpy(z[name + "/table"])[r::m]
        out[name + "/buf"] = rt.received_rows(
            table, ids, n_shards=m, capacity=cap, owner_capacity=case["owner_capacity"]).numpy()
    else:  # padded: one epoch's steps at each batch's own rounds and padded
        from anime_recommendations_tpu_torch.ops.fused_adam import upload
        from anime_recommendations_tpu_torch.parallel import sharded_train as st
        from anime_recommendations_tpu_torch.parallel.mesh import make_world
        from anime_recommendations_tpu_torch.parallel.trainer import init_placed_state
        from anime_recommendations_tpu_torch.train import device_loop as dl
        from anime_recommendations_tpu_torch.train.trainer import train_state_to_numpy

        world = make_world(device="cpu")
        opt, (nu, na, d) = case["optimizer"], case["shape"]
        step = st.ShardedTrainStep(world, l2_reg_factor=1e-3, capacity=cap,
                                   optimizer="fused_adam" if opt == "fused_adam_bf16m" else opt)
        cols = [torch.from_numpy(z[name + "/" + k]).view(case["nb"], m, -1)[:, r]
                for k in ("users", "anime", "ratings", "weights")]
        plans = st.build_plans(step, cols[0], cols[1], (nu, na))
        own = torch.stack([plans.users.rounds, plans.anime.rounds], 1).tolist()
        padded = tuple(x + 1 for x in plans.maxima())
        out[name + "/own_rounds"] = np.array(own)
        table = upload(dl.scalar_table(0, case["nb"], 1e-2), "cpu")
        for label in ("own", "padded"):
            state = init_placed_state(world, nu, na, d, torch.Generator().manual_seed(5),
                                      opt == "fused_adam_bf16m")
            got = []
            for i in range(case["nb"]):
                b = st.Batches(tuple(cols), plans, tuple(own[i]) if label == "own" else padded)
                got += step.step(state, *(c[i] for c in cols), table[i], b.plans_at(i),
                                 b.orders_at(i))
                got += step.eval_sums(state.model, state.model.bn_state(),
                                      *(c[i] for c in cols), b.plans_at(i))
            out[name + f"/{label}/metrics"] = torch.stack(got).numpy()
            out.update({f"{name}/{label}/{k}": v for k, v in train_state_to_numpy(state).items()})
np.savez(sys.argv[2] + f"_{r}.npz", **out)
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(script: Path, m: int, args: list[str]) -> None:
    """Run ``script`` in m gloo ranks on this host; every rank must succeed."""
    port = _free_port()
    procs = []
    for rank in range(m):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE=str(m), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, str(script), *args], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
    finally:
        for p in procs:
            p.kill()


def _table(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def cases(m: int) -> dict:
    """name -> (spec, arrays) of every routing case at world size m."""
    rng = np.random.default_rng(3)
    out = {}

    def exchange(name, table, ids, cap, seed):
        cot = np.random.default_rng(seed).normal(size=(len(ids), table.shape[1])).astype(np.float32)
        out[name] = ({"name": name, "kind": "exchange", "capacity": cap},
                     {"table": table, "ids": ids.astype(np.int64), "cot": cot})

    ids = rng.integers(0, 64, 128)                                  # many duplicates
    exchange("gather", _table(64, 8, 0), ids, rt.default_capacity(128 // m, m), 1)
    # Every id on one owner and 2 slots: the rounds loop must deliver all.
    exchange("skew", _table(64, 4, 0), (np.arange(24) * m) % 64, 2, 2)
    exchange("oob", _table(64, 4, 0), np.array([1, 64, 5, 64 + 7, 63, 64, 64, 2] * 2), 4, 3)
    b = 64
    vjp_ids = np.random.default_rng(4).integers(0, 34, b)           # incl. ids 32, 33 past it
    exchange("vjp_default", _table(32, 4, 1), vjp_ids, rt.default_capacity(b // m, m), 5)
    exchange("vjp_cap2", _table(32, 4, 1), vjp_ids, 2, 6)
    for staged in (1, 2, 64):
        name = f"route_staged{staged}"
        ids = (np.arange(32) * m) % 64                              # one owner: deep overflow
        g = np.random.default_rng(7).normal(size=(32, 4)).astype(np.float32)
        out[name] = ({"name": name, "kind": "route", "capacity": 2, "d": 4, "rows": 64,
                      "staged_rounds": staged}, {"ids": ids.astype(np.int64), "g": g})
    ids = np.random.default_rng(8).integers(0, 66, 96)
    g = np.random.default_rng(9).normal(size=(96, 4)).astype(np.float32)
    out["route_random"] = ({"name": "route_random", "kind": "route", "capacity": 4, "d": 4,
                            "rows": 64, "staged_rounds": 4}, {"ids": ids.astype(np.int64), "g": g})
    out["received"] = ({"name": "received", "kind": "received", "capacity": 3,
                        "owner_capacity": 2 * m * 3 + 5},
                       {"table": _table(64, 4, 2), "ids": rng.integers(0, 70, 64).astype(np.int64)})
    if m > 1:
        for opt in PADDED_OPTIMIZERS:
            name = f"padded_{opt}"
            out[name] = ({"name": name, "kind": "padded", "capacity": 1, "optimizer": opt,
                          "nb": PADDED_BATCHES, "shape": PADDED_SHAPE},
                         padded_batches(m))
    return out


PADDED_OPTIMIZERS = ("adam", "lazy_adam", "fused_adam", "fused_adam_bf16m")
PADDED_BATCHES, PADDED_SHAPE = 3, (256, 64, 8)   # batches; users, anime, D


def padded_batches(m: int) -> dict:
    """3 global batches of 32 rows a rank: distinct ids (many rounds at
    capacity 1), 4 ids (one or two), random ids; some weight-0 rows."""
    rng = np.random.default_rng(21)
    b = 32 * m
    nu, na, _ = PADDED_SHAPE
    users = np.stack([rng.permutation(nu)[:b], rng.integers(0, 4, b), rng.integers(0, nu, b)])
    anime = np.stack([rng.permutation(na)[:b] if b <= na else rng.integers(0, na, b),
                      rng.integers(0, 4, b), rng.integers(0, na, b)])
    return {"users": users.astype(np.int32), "anime": anime.astype(np.int32),
            "ratings": rng.uniform(0, 1, (3, b)).astype(np.float32),
            "weights": (rng.random((3, b)) > 0.1).astype(np.float32)}


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """world size -> (cases, per-rank results) of the port."""
    tmp = tmp_path_factory.mktemp("routing")
    script = tmp / "rank.py"
    script.write_text(RANK_SCRIPT)
    results = {}
    for m in WORLDS:
        cs = cases(m)
        arrays = {f"{name}/{k}": v for name, (_, a) in cs.items() for k, v in a.items()}
        np.savez(tmp / f"in{m}.npz", spec=json.dumps([s for s, _ in cs.values()]), **arrays)
        launch_ranks(script, m, [str(tmp / f"in{m}.npz"), str(tmp / f"out{m}"), str(REPO)])
        ranks = []
        for r in range(m):
            with np.load(tmp / f"out{m}_{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
        results[m] = (cs, ranks)
    return results


def jax_mesh(m):
    shape = {1: (1, 1), 2: (2, 1), 4: (2, 2)}[m]
    return make_mesh(*shape, devices=jax.devices()[:m])


def jax_exchange(m, table, ids, cot, cap):
    """JAX's rows and logical table gradient of one exchange case."""
    mesh = jax_mesh(m)
    ex = jax.jit(jax.shard_map(
        lambda t, i: jrt.exchange_rows(t, i, axis=AXES, n_shards=m, capacity=cap),
        mesh=mesh, in_specs=(P(AXES, None), P(AXES)), out_specs=P(AXES)))
    phys = jnp.asarray(jrt.to_physical(table, m))
    ids = jnp.asarray(ids.astype(np.int32))
    rows = np.asarray(ex(phys, ids))
    grad = jax.grad(lambda t: jnp.vdot(ex(t, ids), jnp.asarray(cot)))(phys)
    return rows, jrt.from_physical(np.asarray(grad), m)


def assemble_stripes(parts):
    """Logical table of the ranks' local stripes."""
    return rt.from_physical(np.concatenate(parts), len(parts))


@pytest.mark.parametrize("name", ["gather", "skew", "oob", "vjp_default", "vjp_cap2"])
@pytest.mark.parametrize("m", WORLDS)
def test_exchange_rows_and_gradient_match_jax(port_results, m, name):
    cs, ranks = port_results[m]
    spec, a = cs[name]
    rows = np.concatenate([rk[name + "/rows"] for rk in ranks])
    grad = assemble_stripes([rk[name + "/grad"] for rk in ranks])
    want_rows, want_grad = jax_exchange(m, a["table"], a["ids"], a["cot"], spec["capacity"])
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-6, atol=1e-6)
    # Against the plain oracle too: rows of ids past the table are zero.
    n = a["table"].shape[0]
    inside = a["ids"] < n
    np.testing.assert_array_equal(rows[inside], a["table"][a["ids"][inside]])
    assert not rows[~inside].any()
    oracle = np.zeros_like(a["table"])
    np.add.at(oracle, a["ids"][inside], a["cot"][inside])
    np.testing.assert_allclose(grad, oracle, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", WORLDS)
def test_round_counts_match_jax(port_results, m):
    cs, ranks = port_results[m]
    for name in ("gather", "skew", "oob", "vjp_cap2"):
        spec, a = cs[name]
        got = {int(rk[name + "/rounds"]) for rk in ranks}
        per_rank = np.asarray(a["ids"], np.int32).reshape(m, -1)
        want = max(int(jrt.plan_stats(jnp.asarray(s), m, spec["capacity"])[2]) for s in per_rank)
        assert got == {want}, name
    if m > 1:
        assert int(ranks[0]["skew/rounds"]) > 1    # the case is multi-round


def jax_route(m, spec, a):
    """JAX's per-rank (oid, og, dense | None, order) of a route case."""
    mesh = jax_mesh(m)
    kw = dict(axis=AXES, n_shards=m, capacity=spec["capacity"], r_local=spec["rows"] // m,
              staged_rounds=spec["staged_rounds"])

    def f(ids, g):
        oid, og, dense = jrt.route_grad_rows(ids, g, **kw)
        order = jrt.receipt_sort_order(ids, **kw)
        return oid, og, (dense if dense is not None else jnp.zeros((0, g.shape[1]))), order

    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(AXES), P(AXES, None)),
                               out_specs=(P(AXES), P(AXES, None), P(AXES, None), P(AXES))))
    oid, og, dense, order = (np.asarray(x) for x in fn(
        jnp.asarray(a["ids"].astype(np.int32)), jnp.asarray(a["g"])))
    split = lambda x: np.split(x, m)   # noqa: E731
    return split(oid), split(og), split(dense), split(order)


@pytest.mark.parametrize("name", ["route_staged1", "route_staged2", "route_staged64",
                                  "route_random"])
@pytest.mark.parametrize("m", WORLDS)
def test_route_grad_rows_matches_jax(port_results, m, name):
    """Staged receipts equal JAX's slot for slot, the dense overflow too, and
    together they are the scatter-add oracle."""
    cs, ranks = port_results[m]
    spec, a = cs[name]
    oids, ogs, denses, orders = jax_route(m, spec, a)
    r_local, d = spec["rows"] // m, spec["d"]
    acc_parts = []
    for rk, oid, og, dense, order in zip(ranks, oids, ogs, denses, orders):
        np.testing.assert_array_equal(rk[name + "/oid"], oid)
        np.testing.assert_allclose(rk[name + "/og"], og, rtol=1e-6, atol=1e-6)
        assert (name + "/dense" in rk) == (dense.size > 0)
        acc = np.zeros((r_local + 1, d), np.float32)
        np.add.at(acc, rk[name + "/oid"], rk[name + "/og"])
        acc = acc[:r_local]
        if dense.size:
            np.testing.assert_allclose(rk[name + "/dense"], dense, rtol=1e-6, atol=1e-6)
            acc += rk[name + "/dense"]
        acc_parts.append(acc)
        # The port's receipt order is the STABLE argsort of the receipts;
        # JAX's (unstable) sorts them the same.
        port_order = rk[name + "/order"]
        np.testing.assert_array_equal(port_order, np.argsort(rk[name + "/oid"], kind="stable"))
        np.testing.assert_array_equal(oid[port_order], oid[order])
    oracle = np.zeros((spec["rows"], d), np.float32)
    keep = a["ids"] < spec["rows"]
    np.add.at(oracle, a["ids"][keep], a["g"][keep])
    np.testing.assert_allclose(assemble_stripes(acc_parts), oracle, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("optimizer", PADDED_OPTIMIZERS)
@pytest.mark.parametrize("m", (2, 4))
def test_padded_rounds_step_is_bit_equal_to_unpadded(port_results, m, optimizer):
    """Each batch's step and eval sums with its plans padded to the epoch's
    largest round count plus one equal, bit for bit, the ones at its own
    count, on every rank; the batches' counts differ and exceed 4 (K1's
    dense branch for the fused ones)."""
    cs, ranks = port_results[m]
    name = f"padded_{optimizer}"
    own = ranks[0][name + "/own_rounds"]
    assert own.max() > 4 and len(set(own[:, 0].tolist())) > 1, own
    for rk in ranks:
        np.testing.assert_array_equal(rk[name + "/own_rounds"], own)
        keys = [k[len(name) + 5:] for k in rk if k.startswith(name + "/own/")]
        assert "user_emb" in keys and "nu.anime_emb" in keys
        for k in keys:
            a, b = rk[f"{name}/own/{k}"], rk[f"{name}/padded/{k}"]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("m", WORLDS)
def test_received_rows_match_jax(port_results, m):
    cs, ranks = port_results[m]
    spec, a = cs["received"]
    mesh = jax_mesh(m)
    fn = jax.jit(jax.shard_map(
        lambda t, i: jrt.received_rows(t, i, axis=AXES, n_shards=m, capacity=spec["capacity"],
                                       owner_capacity=spec["owner_capacity"]),
        mesh=mesh, in_specs=(P(AXES, None), P(AXES)), out_specs=P(AXES)))
    want = np.split(np.asarray(fn(jnp.asarray(jrt.to_physical(a["table"], m)),
                                  jnp.asarray(a["ids"].astype(np.int32)))), m)
    for rk, w in zip(ranks, want):
        np.testing.assert_array_equal(rk["received/buf"], w)


def test_striped_layout_round_trip_matches_jax():
    t = np.arange(24, dtype=np.float32).reshape(12, 2)
    for m in (1, 2, 3, 4, 6, 12):
        p = rt.to_physical(t, m)
        np.testing.assert_array_equal(p, jrt.to_physical(t, m))
        np.testing.assert_array_equal(rt.from_physical(p, m), t)
        pt = rt.to_physical(torch.from_numpy(t), m)
        np.testing.assert_array_equal(pt.numpy(), p)
        np.testing.assert_array_equal(rt.from_physical(pt, m).numpy(), t)
        for s in range(m):   # block s is the stripe t[s::m]
            np.testing.assert_array_equal(p.reshape(m, -1, 2)[s], t[s::m])
        ids = np.arange(40, dtype=np.int32)
        np.testing.assert_array_equal(rt.owner_of(torch.from_numpy(ids), m).numpy(),
                                      np.asarray(jrt.owner_of(jnp.asarray(ids), m)))
        np.testing.assert_array_equal(rt.local_of(torch.from_numpy(ids), m).numpy(),
                                      np.asarray(jrt.local_of(jnp.asarray(ids), m)))


def test_sizes_and_comm_accounting_match_jax():
    for b, m in ((1, 1), (128, 1), (64, 2), (10_000, 1), (2_500, 4), (5, 8)):
        assert rt.default_capacity(b, m) == jrt.default_capacity(b, m)
        for cap in (2, 64, 512):
            assert rt.receipt_slots(b, m, cap) == jrt.receipt_slots(b, m, cap)
            assert rt.exchange_comm_bytes(b, 128, m, cap, rounds=3) == jrt.exchange_comm_bytes(
                b, 128, m, cap, rounds=3)
        assert rt.psum_comm_bytes(b, 128, m) == jrt.psum_comm_bytes(b, 128, m)
    for m in (1, 2, 8):
        for s in range(m):
            assert rt.pad_sentinel(64, m, s) == jrt.pad_sentinel(64, m, s)
    for args in ((8, -1, 1), (8, 2, -1), (8, 4, 2), (1, -1, 1)):
        assert tmesh.mesh_shape_for(*args) == tuple(jax_mesh_shape_for(*args))
    t = np.ones((10, 4), np.float32)
    assert tmesh.pad_table(t, 4).shape == (12, 4) and not tmesh.pad_table(t, 4)[10:].any()


@pytest.mark.parametrize("m,cap", [(8, 4), (1, 3), (4, 2)])
def test_plan_stats_match_jax(m, cap):
    ids = np.concatenate([[0, 8, 16, 1, 1, 1, 2, 3],
                          np.random.default_rng(m).integers(0, 50, 56)]).astype(np.int32)
    got = rt.plan_stats(ids, m, cap)
    want = tuple(int(x) for x in jrt.plan_stats(jnp.asarray(ids), m, cap))
    assert got == want
    assert rt.plan_stats(torch.from_numpy(ids[:8]).numpy(), 8, 4) == (6, 3, 1)
