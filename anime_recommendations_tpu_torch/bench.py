"""The benchmark suite on the port: training throughput, retrieval time and
exactness, IVF recall and serving latency.

    python -m anime_recommendations_tpu_torch.cli bench [--device cuda|cpu]

Counterpart of the repository root's bench.py, the JAX package's suite: its
eleven sections in its order, its keys with their meaning, its sizes
(``FULL``), protocols and data. numpy's default_rng(0) threads through
sections 1-9 and default_rng(5) through section 10, every value drawn in
bench.py's order, so every table, batch and query set is bench.py's. It
prints ONE JSON line on stdout,

  {"metric": "train_examples_per_sec", "value": N, "unit": "examples/s",
   "vs_baseline": null, "details": {...}}

and, on stderr just before it, ``[bench] launches {...}``, the kernel
launches of the run (ops/_kernels.launches). Everything else goes to
stderr. ``details`` adds ``device`` (the card's name and power limit as
nvidia-smi gives them, or "cpu") and ``backend`` ("cuda" or "cpu").
``--device cpu`` runs the kernels' plain versions; ``--device cuda`` without
a card raises.

How it measures, where it departs from bench.py (ROADMAP.md, Queue 3):

* Host-clock keys (steps, epochs, the chained ``_ms`` and ``_qps`` keys,
  ``serve_*``): bench.py's method. A warm-up, then the best of 3 segments
  (5 or 7 for serving), each closed by a host fetch.
* ``_ms_dev`` keys: the device time of all the kernels of one call under
  torch.profiler (utils/profiling.profiled, over the 48 distinct query
  batches in turn), where bench.py runs a lax.scan harness and subtracts
  its overhead, ``scan_harness_base_ms``; that key has no counterpart here.
  ``_ms_dev_raw`` is the measurement, ``_ms_dev`` the larger of it and the
  table's bytes at the card's memory rate (HBM_BYTES_PER_S, where bench.py
  divides by another chip's rate). On the CPU the device is the host:
  ``_ms_dev_raw`` is the host-clock ms of one call there.
* ``vs_baseline`` is null: bench.py divides by a rate taken on other
  hardware.
* Every ``serve_*`` key runs on the card's context. bench.py puts the
  ``_host_ms`` context on its host CPU to keep a remote device's round trip
  out of the loop, and there is no such round trip here.
* The numpy top-k oracles take np.argpartition, which selects the same set
  as bench.py's full sort.
* Initial states and epoch shuffles come from torch.Generators: bench.py's
  PRNGKey(n) and fold_in(key, n) become manual_seed(n). Parity with
  jax.random is statistical.
* Section 6 also scans the first int8 oracle query alone, on the one-query
  branch of the int8 kernel (bench.py's scans take 8 to 256 queries), and
  requires the batched call's top-10 for it.

Sections 4 and 5 run on a process group of one rank: the one that exists,
or one made here (NCCL on the card, gloo on the CPU, on a HashStore) and
destroyed at the end. bench.py pins a 1 x 1 mesh, so a larger world raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from anime_recommendations_tpu_torch.ops import _kernels

# NVIDIA H100 SXM's memory rate (data sheet): the floor of the _ms_dev keys.
HBM_BYTES_PER_S = 3.35e12
K = 10            # every scan's top-k
L2 = 1e-4
LR = 5e-5
TRAINED_LR = 3e-4
LATENT = 16       # rank of section 7's table and section 10's teacher
WATCHED = 500     # section 8's masked catalog rows
SERVE_SEED = 7


@dataclasses.dataclass(frozen=True)
class BenchSizes:
    """Every size of the suite. FULL is bench.py's; tests run smaller ones."""

    n_users: int = 91_641          # sections 1-2: the reference's trained tables
    n_anime: int = 17_560
    d: int = 128
    batch: int = 10_000
    step_batches: int = 8          # section 1: distinct batches in turn
    steps: int = 30                # section 1: steps per timed segment
    epoch_rows: int = 2_000_000    # section 2
    n_users_full: int = 350_000    # sections 3-6: the full dataset's users
    full_rows: int = 1_000_000     # section 3
    routed_steps: int = 33         # section 4
    routed_batches: int = 50       # section 5
    query_batches: int = 48        # sections 6-8: distinct query batches per timing
    wide_q: int = 256              # the batched width; section 10's hot users
    oracle_rows: int = 50_000      # section 9
    ivf_rows: int = 2_000_000      # section 7
    ivf_clusters: int = 2048
    ivf_iters: int = 8
    ivf_queries: int = 64
    trained_users: int = 91_641    # section 10
    trained_users_full: int = 350_000
    trained_rows: int = 2_000_000
    trained_epochs: int = 6
    serve_users: int = 2_000       # section 11
    serve_anime: int = 500
    serve_interactions: int = 200_000
    serve_d: int = 64


FULL = BenchSizes()


# ---- shared helpers ----------------------------------------------------------------


def _gen(seed: int) -> torch.Generator:
    """The CPU generator standing for bench.py's PRNGKey(seed) / fold_in(key, seed)."""
    return torch.Generator().manual_seed(seed)


def _batch(rng, n_users: int, n_anime: int, b: int, dev) -> tuple[torch.Tensor, ...]:
    """One training batch, drawn as bench.py draws it: users, anime, ratings."""
    users = torch.from_numpy(rng.integers(0, n_users, b).astype(np.int32))
    anime = torch.from_numpy(rng.integers(0, n_anime, b).astype(np.int32))
    ratings = torch.from_numpy(rng.uniform(0, 1, b).astype(np.float32))
    return (users.to(dev), anime.to(dev), ratings.to(dev),
            torch.ones(b, dtype=torch.float32, device=dev))


def _dataset(rng, n_users: int, n_anime: int, rows: int):
    from anime_recommendations_tpu_torch.data.dataset import RatingsDataset

    return RatingsDataset(
        users=rng.integers(0, n_users, rows).astype(np.int32),
        anime=rng.integers(0, n_anime, rows).astype(np.int32),
        ratings=rng.uniform(0, 1, rows).astype(np.float32),
    )


def _unit_rows(rng, n: int, d: int) -> np.ndarray:
    w = rng.standard_normal((n, d), dtype=np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    return w


def _np_topk(scores: np.ndarray, k: int = K) -> np.ndarray:
    """Row-wise ids of the k largest scores, best first (bench.py's argsort
    oracles select the same set)."""
    part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(scores, part, axis=1), axis=1)
    return np.take_along_axis(part, order, axis=1)


def overlap(got, want, rows: int, digits: int) -> float:
    """Mean over the first ``rows`` queries of |got & want| / 10, rounded."""
    got, want = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) for x in (got, want))
    return round(float(np.mean([len(set(got[i]) & set(want[i])) / K for i in range(rows)])),
                 digits)


def _floor_ms(n_rows: int, d: int, itemsize: int) -> float:
    """One read of the table at the card's memory rate, in ms."""
    return n_rows * d * itemsize / HBM_BYTES_PER_S * 1e3


def device_ms(call, qstack: torch.Tensor, dev: torch.device) -> float:
    """Device ms of one ``call(queries)``, the queries each batch of
    ``qstack`` in turn: on the card, every kernel of a call under
    torch.profiler (utils/profiling.profiled); on the CPU, the host-clock
    time of a call, best of 3 passes."""
    n = qstack.shape[0]
    turn = itertools.cycle(range(n))

    def one():
        return call(qstack[next(turn)])

    if dev.type == "cuda":
        from anime_recommendations_tpu_torch.utils.profiling import profiled

        return profiled(one, reps=n)["device_ms"]
    one()
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e3


def dev_keys(details: dict, key: str, call, qstack: torch.Tensor, dev, floor_ms: float) -> float:
    """bench.py's dev_keys: ``<key>_ms_dev_raw``, device_ms of ``call``, and
    ``<key>_ms_dev``, the larger of it and ``floor_ms``, which it returns."""
    raw = device_ms(call, qstack, dev)
    details[f"{key}_ms_dev_raw"] = round(raw, 3)
    details[f"{key}_ms_dev"] = round(max(raw, floor_ms), 3)
    return max(raw, floor_ms)


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()


@contextlib.contextmanager
def one_rank_group(dev: torch.device):
    """A torch.distributed group of world size 1 for sections 4-5: the one
    that exists, or one made here on a HashStore (no port, so processes
    cannot collide) and destroyed on exit."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise ValueError(f"the bench runs a 1 x 1 mesh; this process group has "
                             f"{dist.get_world_size()} ranks")
        yield
        return
    from anime_recommendations_tpu_torch.parallel.distributed import shutdown

    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        shutdown()


# ---- data builders (bench.py's draws) ----------------------------------------------


def latent_table(rng, n: int, d: int, device) -> torch.Tensor:
    """bench.py:476-490: [n, d] unit rows of a rank-16 latent, the clustered
    geometry of trained tables. Draws [n, 16] then [16, d] standard normals
    (f64, cast to f32), the second divided by 4; rows u @ p over their norm,
    in f32 on ``device``."""
    lat_u = rng.standard_normal((n, LATENT)).astype(np.float32)
    lat_p = rng.standard_normal((LATENT, d)).astype(np.float32) / 4.0
    w = torch.from_numpy(lat_u).to(device) @ torch.from_numpy(lat_p).to(device)
    return (w / torch.linalg.norm(w, dim=1, keepdim=True)).contiguous()


class Teacher(NamedTuple):
    """Section 10's ratings of a latent teacher, and what the 350k part reuses."""

    users: np.ndarray         # [rows] int32, pareto-skewed: popular users at low ids
    anime: np.ndarray         # [rows] int32, the same
    ratings: np.ndarray       # [rows] f32
    anime_latent: np.ndarray  # [n_anime, 16]


def _teacher_ratings(rng, u_lat, zu, a_lat, za) -> np.ndarray:
    aff = np.einsum("ij,ij->i", u_lat[zu], a_lat[za])
    return 1.0 / (1.0 + np.exp(-(3.0 * aff + rng.normal(0, 0.35, len(zu)))))


def zipf_teacher(rng, n_users: int, n_anime: int, rows: int) -> Teacher:
    """bench.py:572-584: user and anime latent factors [n, 16] / 4, then
    ``rows`` ratings of user min(pareto(1.1) * 40, n_users - 1) and anime
    min(pareto(1.05) * 15, n_anime - 1), rated sigmoid(3 <u, a> + N(0, 0.35)),
    drawn from ``rng`` (default_rng(5) in the suite) in that order."""
    lat = LATENT
    u_lat = rng.normal(size=(n_users, lat)).astype(np.float32) / np.sqrt(lat)
    a_lat = rng.normal(size=(n_anime, lat)).astype(np.float32) / np.sqrt(lat)
    zu = np.minimum((rng.pareto(1.1, rows) * 40).astype(np.int64), n_users - 1)
    za = np.minimum((rng.pareto(1.05, rows) * 15).astype(np.int64), n_anime - 1)
    y = _teacher_ratings(rng, u_lat, zu, a_lat, za)
    return Teacher(zu.astype(np.int32), za.astype(np.int32), y.astype(np.float32), a_lat)


def zipf_teacher_users(rng, teacher: Teacher, n_users: int) -> Teacher:
    """bench.py:669-678: new user factors and skewed user ids for
    ``n_users`` users, rated against ``teacher``'s anime factors and ids."""
    lat = LATENT
    u_lat = rng.normal(size=(n_users, lat)).astype(np.float32) / np.sqrt(lat)
    zu = np.minimum((rng.pareto(1.1, len(teacher.users)) * 40).astype(np.int64), n_users - 1)
    y = _teacher_ratings(rng, u_lat, zu, teacher.anime_latent, teacher.anime)
    return teacher._replace(users=zu.astype(np.int32), ratings=y.astype(np.float32))


# ---- sections 1-5: training ------------------------------------------------------


def _train_per_step(rng, s: BenchSizes, dev, details: dict) -> None:
    """Section 1 (bench.py:35-75): dense-Adam steps one at a time over 8
    distinct batches, the host fetch of the last loss closing each segment."""
    from anime_recommendations_tpu_torch.train.trainer import init_train_state, train_step

    state = init_train_state(s.n_users, s.n_anime, s.d, generator=_gen(0), device=dev)
    batches = [_batch(rng, s.n_users, s.n_anime, s.batch, dev) for _ in range(s.step_batches)]

    def run_steps(state, n):
        loss = None
        for i in range(n):
            state, loss, _ = train_step(state, *batches[i % len(batches)], LR, L2)
        return state, loss

    state, loss = run_steps(state, 3)
    float(loss)
    seg = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, loss = run_steps(state, s.steps)
        float(loss)
        seg.append(time.perf_counter() - t0)
    best = min(seg)
    details["train_step_ms"] = round(best / s.steps * 1e3, 3)
    details["train_per_step_examples_per_sec"] = round(s.steps * s.batch / best)


def _best_secs(state, epoch, seeds) -> float:
    """A warm-up epoch (generator 0), then the best of one epoch per seed,
    each closed by a host fetch of its last loss. ``epoch(state, generator)``
    returns (state, losses)."""
    seg = []
    for seed in (None, *seeds):
        t0 = time.perf_counter()
        state, losses = epoch(state, _gen(seed or 0))
        float(losses[-1])
        if seed is not None:
            seg.append(time.perf_counter() - t0)
    return min(seg)


def _device_epoch(data, s: BenchSizes, opt: str):
    """bench.py's device-resident epoch (train/device_loop.train_epoch with
    sorted_scatter) as an ``epoch`` of _best_secs."""
    from anime_recommendations_tpu_torch.train import device_loop as dl

    def epoch(state, generator):
        return dl.train_epoch(state, data, generator, LR, s.batch, L2, sorted_scatter=True,
                              optimizer=opt)[:2]

    return epoch


def _fresh_state(n_users: int, s: BenchSizes, seed: int, opt: str, dev):
    from anime_recommendations_tpu_torch.train.trainer import cast_table_moments, init_train_state

    state = init_train_state(n_users, s.n_anime, s.d, generator=_gen(seed), device=dev)
    return cast_table_moments(state, torch.bfloat16) if opt == "fused_adam_bf16m" else state


def _train_epochs(rng, s: BenchSizes, dev, details: dict) -> float:
    """Section 2 (bench.py:77-127): device-resident epochs over 2M rows for
    adam, fused_adam and fused_adam_bf16m (its own keys, outside the
    headline). Returns the headline examples/s."""
    from anime_recommendations_tpu_torch.train import device_loop as dl

    data = dl.stage(_dataset(rng, s.n_users, s.n_anime, s.epoch_rows), s.batch, seed=0,
                    device=dev)
    secs = {}
    for opt in ("adam", "fused_adam", "fused_adam_bf16m"):
        state = _fresh_state(s.n_users, s, 1, opt, dev)
        secs[opt] = _best_secs(state, _device_epoch(data, s, opt), range(3))
        details[f"train_epoch_{opt}_step_ms"] = round(
            secs[opt] / (s.epoch_rows / s.batch) * 1e3, 3)
        del state
    details["train_bf16m_examples_per_sec"] = round(s.epoch_rows / secs.pop("fused_adam_bf16m"))
    epoch_secs = min(secs.values())
    details["train_epoch_secs_2M_rows"] = round(epoch_secs, 3)
    details["train_examples_per_sec"] = round(s.epoch_rows / epoch_secs)
    return s.epoch_rows / epoch_secs


def _train_350k(rng, s: BenchSizes, dev, details: dict) -> None:
    """Section 3 (bench.py:129-163): the four optimizers' epochs on a
    350,000-row user table."""
    from anime_recommendations_tpu_torch.train import device_loop as dl

    data = dl.stage(_dataset(rng, s.n_users_full, s.n_anime, s.full_rows), s.batch, seed=0,
                    device=dev)
    for opt in ("adam", "lazy_adam", "fused_adam", "fused_adam_bf16m"):
        state = _fresh_state(s.n_users_full, s, 2, opt, dev)
        best = _best_secs(state, _device_epoch(data, s, opt), range(10, 13))
        details[f"train350k_{opt}_step_ms"] = round(best / (s.full_rows / s.batch) * 1e3, 3)
        details[f"train350k_{opt}_examples_per_sec"] = round(s.full_rows / best)
        del state


def _routed_epoch(sstep, state, train, evals, generator):
    """bench.py's planned routed epoch (parallel/sharded_train.build_epoch_fn
    with shuffle and precomputed plans): the batches in an order drawn per
    epoch, each with its plans and receipt orders, then the eval batches'
    sums (sharded_train.run_epoch: on the card one replay of the epoch's CUDA
    graph, the order copied into its static buffer). Returns (state,
    losses)."""
    from anime_recommendations_tpu_torch.parallel.sharded_train import run_epoch

    order = torch.randperm(train.n, generator=generator)
    losses, *_ = run_epoch(sstep, state, LR, train, evals, order)
    return state, losses


def _train_routed(rng, s: BenchSizes, dev, details: dict) -> None:
    """Sections 4-5 (bench.py:165-283) on a 1 x 1 mesh: the routed fused
    step one at a time, then the planned routed epoch (plans computed once
    with one host read of their round counts, reused every epoch, 2 eval
    batches per epoch) with f32 and bf16 moments."""
    from anime_recommendations_tpu_torch.parallel.mesh import make_world
    from anime_recommendations_tpu_torch.parallel.sharded_train import (
        ShardedTrainStep,
        place_state,
        plan_batches,
    )

    world = make_world(1, 1, device=dev)
    sstep = ShardedTrainStep(world, l2_reg_factor=L2, routing="alltoall", optimizer="fused_adam")
    state = place_state(_fresh_state(s.n_users_full, s, 3, "fused_adam", dev), world)
    batches = [_batch(rng, s.n_users_full, s.n_anime, s.batch, dev)
               for _ in range(s.routed_steps)]
    state, loss, _ = sstep.train_step(state, *batches[0], LR)
    float(loss)
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, loss, _ = sstep.train_step(state, *b, LR)
    float(loss)
    details["train350k_sharded_fused_step_ms"] = round(
        (time.perf_counter() - t0) / (len(batches) - 1) * 1e3, 3)
    del state, batches

    nb, rows = s.routed_batches, s.routed_batches * s.batch
    cols = []
    for high in (s.n_users_full, s.n_anime):
        cols.append(torch.from_numpy(rng.integers(0, high, rows).astype(np.int32)))
    cols.append(torch.from_numpy(rng.uniform(0, 1, rows).astype(np.float32)))
    cols.append(torch.ones(rows, dtype=torch.float32))
    train = plan_batches(sstep, (c.to(dev).view(nb, s.batch) for c in cols),
                         table_rows=(s.n_users_full, s.n_anime))
    evals = train.select(slice(0, 2))
    for opt, seed, reps, key in (
            ("fused_adam", 4, range(3), "train350k_sharded_fused_epoch"),
            ("fused_adam_bf16m", 5, range(20, 23), "train350k_sharded_bf16m_epoch")):
        state = place_state(_fresh_state(s.n_users_full, s, seed, opt, dev), world)
        best = _best_secs(state, lambda st, g: _routed_epoch(sstep, st, train, evals, g), reps)
        details[f"{key}_step_ms"] = round(best / nb * 1e3, 3)
        if opt == "fused_adam":
            details[f"{key}_examples_per_sec"] = round(rows / best)
        del state


# ---- sections 6-9: retrieval --------------------------------------------------------


def _qstack(w: np.ndarray, q: int, n: int, dtype, dev) -> torch.Tensor:
    """bench.py's qstack_for: n query batches of q consecutive rows,
    batch i starting at row (97 i) mod (len(w) - q). [n, q, d]."""
    return torch.from_numpy(np.stack([w[(i * 97) % (len(w) - q):][:q] for i in range(n)])).to(
        dev, dtype)


def _chained_ms(call, queries: list) -> float:
    """bench.py's chained harness: best of 3 segments of every query batch
    in turn, closed by a host fetch of the last result, less one call's round
    trip; ms per call."""
    call(queries[0])[0].cpu()
    per = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        call(queries[0])[0].cpu()
        rtt = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = [call(q) for q in queries]
        outs[-1][0].cpu()
        per = min(per, (time.perf_counter() - t0 - rtt) / len(queries))
    return per * 1e3


class Tables(NamedTuple):
    """Section 6's random unit table and what sections 8-9 scan again."""

    w: np.ndarray             # [350,000, d] unit rows
    anime: torch.Tensor       # its first 17,560 rows on the device
    queries_wide: torch.Tensor  # [48, 256, d] query batches of w's rows


def _retrieval(rng, s: BenchSizes, dev, details: dict) -> Tables:
    """Section 6 (bench.py:286-465): chained queries/s over random unit
    tables, device ms per call at 8 and 256 queries (f32, bf16, int8), and
    exactness at 256 (f32) and 16 queries (int8) against numpy. Returns the
    350,000-row table W and the tables and query stacks sections 8-9 use."""
    from anime_recommendations_tpu_torch.ops.quantized import quantize_rows, quantized_topk
    from anime_recommendations_tpu_torch.ops.topk import cosine_topk

    d, n = s.d, s.query_batches
    topk10 = lambda t, q: cosine_topk(t, q, K)  # noqa: E731
    for name, n_rows in (("anime", s.n_anime), ("user", s.n_users_full)):
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            w = _unit_rows(rng, n_rows, d)
            table = torch.from_numpy(w).to(dev, dtype)
            qs = [torch.from_numpy(w[(i * 8) % (n_rows - 8):][:8]).to(dev, dtype)
                  for i in range(n)]
            raw = _chained_ms(lambda q: topk10(table, q), qs)
            ms = max(raw, _floor_ms(n_rows, d, table.element_size()))
            key = f"topk_{name}_{tag}_q8"
            details[f"{key}_qps"] = round(8 / (ms / 1e3))
            details[f"{key}_ms"] = round(ms, 3)
            details[f"{key}_ms_raw"] = round(raw, 3)
            if raw < ms:
                details[f"{key}_clamped"] = True
            del table, qs

    w = _unit_rows(rng, s.n_users_full, d)

    def scan_keys(key, fn, table, qstack, n_rows, itemsize) -> float:
        return dev_keys(details, key, lambda q: fn(table, q), qstack, dev,
                        _floor_ms(n_rows, d, itemsize))

    qs8 = _qstack(w, 8, n, torch.float32, dev)
    w32 = torch.from_numpy(w).to(dev)
    scan_keys("topk_user_f32_q8", topk10, w32, qs8, s.n_users_full, 4)
    wa = w[:s.n_anime]
    wa32 = torch.from_numpy(wa).to(dev)
    scan_keys("topk_anime_f32_q8", topk10, wa32, _qstack(wa, 8, n, torch.float32, dev),
              s.n_anime, 4)
    qs_wide = _qstack(w, s.wide_q, n, torch.float32, dev)
    per = scan_keys(f"topk_user_f32_q{s.wide_q}", topk10, w32, qs_wide, s.n_users_full, 4)
    details[f"topk_user_f32_q{s.wide_q}_qps"] = round(s.wide_q / (per / 1e3))
    wb16 = w32.to(torch.bfloat16)
    scan_keys("topk_user_bf16_q8", topk10, wb16, _qstack(w, 8, n, torch.bfloat16, dev),
              s.n_users_full, 2)
    per = scan_keys(f"topk_user_bf16_q{s.wide_q}", topk10, wb16,
                    _qstack(w, s.wide_q, n, torch.bfloat16, dev), s.n_users_full, 2)
    details[f"topk_user_bf16_q{s.wide_q}_qps"] = round(s.wide_q / (per / 1e3))
    del wb16

    q = s.wide_q
    ids = cosine_topk(w32, torch.from_numpy(w[:q]).to(dev), K)[1]
    details[f"topk_q{q}_overlap_vs_oracle"] = overlap(ids, _np_topk(w[:q] @ w.T), q, 5)

    qt = quantize_rows(w32)
    qs = [torch.from_numpy(w[(i * 8) % (s.n_users_full - 8):][:8]).to(dev)
          for i in range(n // 2)]
    raw = _chained_ms(lambda q: quantized_topk(qt, q, k=K), qs)
    ms = max(raw, _floor_ms(s.n_users_full, d, 1))
    details["topk_user_int8_q8_qps"] = round(8 / (ms / 1e3))
    details["topk_user_int8_q8_ms"] = round(ms, 3)
    details["topk_user_int8_q8_ms_raw"] = round(raw, 3)
    if raw < ms:
        details["topk_user_int8_q8_clamped"] = True
    topk10q = lambda t, q: quantized_topk(t, q, k=K)  # noqa: E731
    scan_keys("topk_user_int8_q8", topk10q, qt, qs8, s.n_users_full, 1)
    per = scan_keys(f"topk_user_int8_q{s.wide_q}", topk10q, qt, qs_wide, s.n_users_full, 1)
    details[f"topk_user_int8_q{s.wide_q}_qps"] = round(s.wide_q / (per / 1e3))
    q16 = torch.from_numpy(w[:16]).to(dev)
    iq = quantized_topk(qt, q16, k=K)[1]
    details["topk_int8_overlap_vs_oracle"] = overlap(iq, _np_topk(w[:16] @ w.T), 16, 4)
    # The one-query int8 branch (no query count above reaches it): the same
    # top-10 as the batched call's first row.
    one = quantized_topk(qt, q16[:1], k=K)[1]
    if set(one[0].tolist()) != set(iq[0].tolist()):
        raise AssertionError(f"int8 top-10 of one query {one[0].tolist()} differs from the "
                             f"batched call's {iq[0].tolist()}")
    del qt
    return Tables(w, wa32, qs_wide)


def ivf_recalls(index, table: torch.Tensor, queries: torch.Tensor, probes=(8, 32)) -> dict:
    """Section 7's recall@10 of ``queries`` through ``index`` at each probe
    count against the exact scan (K3) of ``table``: {probes: recall}."""
    from anime_recommendations_tpu_torch.ops.ivf import ivf_topk
    from anime_recommendations_tpu_torch.ops.topk import masked_topk

    exact = masked_topk(table, queries, K, exact_scan=True)[1]
    return {p: overlap(ivf_topk(index, queries, K, probes=p)[1], exact, queries.shape[0], 4)
            for p in probes}


def _ivf(rng, s: BenchSizes, dev, details: dict) -> None:
    """Section 7 (bench.py:467-518): IVF over 2M rows of a rank-16 latent:
    build seconds, recall@10 at 8 and 32 probes, one query's device ms at
    each and through the two-stage exact scan."""
    from anime_recommendations_tpu_torch.ops.ivf import build_ivf, ivf_topk
    from anime_recommendations_tpu_torch.ops.topk import masked_topk

    w = latent_table(rng, s.ivf_rows, s.d, dev)
    float(w[0, 0])
    t0 = time.perf_counter()
    index = build_ivf(w, n_clusters=s.ivf_clusters, iters=s.ivf_iters, seed=3)
    float(index.centroids[0, 0])
    details["ivf2m_build_secs"] = round(time.perf_counter() - t0, 2)
    queries = w[torch.from_numpy(rng.integers(0, s.ivf_rows, s.ivf_queries)).to(dev)]
    recalls = ivf_recalls(index, w, queries)
    one = torch.stack([w[torch.from_numpy(rng.integers(0, s.ivf_rows, 1)).to(dev)]
                       for _ in range(s.query_batches)])
    for p, recall in recalls.items():
        details[f"ivf2m_p{p}_recall_at10"] = recall
        raw = device_ms(lambda q, p=p: ivf_topk(index, q, K, probes=p), one, dev)
        details[f"ivf2m_q1_p{p}_ms_dev"] = round(max(raw, 0.0), 3)
    raw = device_ms(lambda q: masked_topk(w, q, K), one, dev)
    details["ivf2m_exact_q1_ms_dev"] = round(max(raw, _floor_ms(s.ivf_rows, s.d, 4)), 3)


def _scoring(rng, s: BenchSizes, dev, details: dict, t: Tables) -> None:
    """Section 8 (bench.py:520-547): the folded-head, masked score_topk over
    the catalog at 1 and 256 users per call, and its exactness."""
    from anime_recommendations_tpu_torch.ops.scoring import score_topk

    head = torch.tensor([2.3, -0.8], dtype=torch.float32, device=dev)
    watched = np.zeros(s.n_anime, bool)
    watched[rng.choice(s.n_anime, WATCHED, replace=False)] = True
    keep = torch.from_numpy(~watched).to(dev)
    w = t.w
    score10 = lambda q: score_topk(t.anime, q, head, K, mask=keep)  # noqa: E731
    for q, stack in ((1, _qstack(w, 1, s.query_batches, torch.float32, dev)),
                     (s.wide_q, t.queries_wide)):
        per = dev_keys(details, f"score_topk_catalog_q{q}", score10, stack, dev,
                       _floor_ms(s.n_anime, s.d, 4))
        details[f"score_topk_catalog_q{q}_qps"] = round(q / (per / 1e3))
    ids = score10(torch.from_numpy(w[:64]).to(dev))[1]
    sc = 1.0 / (1.0 + np.exp(-(2.3 * (w[:64] @ w[:s.n_anime].T) - 0.8)))
    sc[:, watched] = -np.inf
    details["score_topk_overlap_vs_oracle"] = overlap(ids, _np_topk(sc), 64, 4)


def _oracle_overlap(s: BenchSizes, dev, details: dict, w: np.ndarray) -> None:
    """Section 9 (bench.py:549-559): f32 top-10 of 16 rows of a 50,000-row
    table against numpy."""
    from anime_recommendations_tpu_torch.ops.topk import cosine_topk

    table = torch.from_numpy(w[:s.oracle_rows]).to(dev)
    ids = cosine_topk(table, table[:16], K)[1]
    details["topk_overlap_vs_oracle"] = overlap(
        ids, _np_topk(w[:16] @ w[:s.oracle_rows].T), 16, 4)


# ---- section 10: trained tables ----------------------------------------------------


def trained_overlaps(user_n: torch.Tensor, n_hot: int) -> dict:
    """Section 10's overlaps (bench.py:596-661) on a normalized user table:
    the ``n_hot`` hottest (lowest-id) users' top-10 against the exact scan
    (K3), through the unshuffled two-stage scan, the shuffled table (seed 13)
    at the default depth and at top_r=3, its int8 copy at n_hot and 8
    queries, and its bf16 copy against the f32 and the bf16 exact scans."""
    from anime_recommendations_tpu_torch.ops.quantized import quantize_rows
    from anime_recommendations_tpu_torch.ops.topk import (
        ShuffledTable,
        cosine_topk,
        masked_topk,
        shuffle_rows,
    )

    hot = user_n[:n_hot].contiguous()
    exact = masked_topk(user_n, hot, K, exact_scan=True)[1]
    sh = shuffle_rows(user_n, seed=13)
    sh_q = ShuffledTable(quantize_rows(sh.table), sh.perm, sh.inv)
    sh_b = ShuffledTable(sh.table.to(torch.bfloat16), sh.perm, sh.inv)
    bf_table, bf_hot = sh.table.to(torch.bfloat16), hot.to(torch.bfloat16)
    out = {
        "twostage_unshuffled": overlap(masked_topk(user_n, hot, K)[1], exact, n_hot, 5),
        "twostage_vs_exact": overlap(cosine_topk(sh, hot, K)[1], exact, n_hot, 5),
        "twostage_topr3": overlap(cosine_topk(sh, hot, K, top_r=3)[1], exact, n_hot, 5),
        "int8_vs_exact": overlap(cosine_topk(sh_q, hot, K)[1], exact, n_hot, 5),
        "int8_q8_vs_exact": overlap(cosine_topk(sh_q, hot[:8], K)[1], exact, 8, 5),
        "bf16_vs_exact": overlap(cosine_topk(sh_b, hot, K)[1], exact, n_hot, 5),
        "bf16_vs_bf16exact": overlap(
            masked_topk(bf_table, bf_hot, K)[1],
            masked_topk(bf_table, bf_hot, K, exact_scan=True)[1], n_hot, 5),
    }
    return {f"topk_trained_{k}_overlap": v for k, v in out.items()}


def _train_teacher(teacher: Teacher, n_users: int, s: BenchSizes, init_seed: int,
                   stage_seed: int, epoch_seed: int, dev) -> torch.Tensor:
    """6 fused_adam epochs at lr 3e-4 on the teacher's ratings; the
    normalized user table."""
    from anime_recommendations_tpu_torch.data.dataset import RatingsDataset
    from anime_recommendations_tpu_torch.models.two_tower import normalized_tables
    from anime_recommendations_tpu_torch.train import device_loop as dl

    ds = RatingsDataset(users=teacher.users, anime=teacher.anime, ratings=teacher.ratings)
    state = _fresh_state(n_users, s, init_seed, "fused_adam", dev)
    data = dl.stage(ds, s.batch, seed=stage_seed, device=dev)
    for ep in range(s.trained_epochs):
        state, losses, _, _ = dl.train_epoch(state, data, _gen(epoch_seed + ep), TRAINED_LR,
                                             s.batch, L2, sorted_scatter=True,
                                             optimizer="fused_adam")
    float(losses[-1])
    with torch.no_grad():
        return normalized_tables(state.model)[1].contiguous()


def _trained(s: BenchSizes, dev, details: dict) -> None:
    """Section 10 (bench.py:561-695): train on latent-teacher ratings of
    pareto-skewed ids (default_rng(5)) at 91,641 users, serve the hottest
    users through every scan flavour against the exact scan, then close the
    scale gap at 350,000 users."""
    from anime_recommendations_tpu_torch.ops.topk import cosine_topk, masked_topk, shuffle_rows

    trng = np.random.default_rng(5)
    teacher = zipf_teacher(trng, s.trained_users, s.n_anime, s.trained_rows)
    user_n = _train_teacher(teacher, s.trained_users, s, 6, 1, 100, dev)
    details.update(trained_overlaps(user_n, s.wide_q))
    del user_n

    teacher = zipf_teacher_users(trng, teacher, s.trained_users_full)
    user_n = _train_teacher(teacher, s.trained_users_full, s, 8, 2, 200, dev)
    hot = user_n[:s.wide_q].contiguous()
    exact = masked_topk(user_n, hot, K, exact_scan=True)[1]
    got = cosine_topk(shuffle_rows(user_n, seed=13), hot, K)[1]
    details["topk_trained350k_twostage_vs_exact_overlap"] = overlap(got, exact, s.wide_q, 5)


# ---- section 11: serving -----------------------------------------------------------


def _timed_best(call, reps: int) -> float:
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return round(best * 1e3, 2)


def _serving(s: BenchSizes, dev, details: dict) -> None:
    """Section 11 (bench.py:697-786): Engine requests on a context built
    from synthetic data: cold and warm (best of 5) similar_anime and
    user_recs, the similar-users cache, then five endpoints' best of 7 on a
    fresh Engine over the same context (``_host_ms``)."""
    from anime_recommendations_tpu_torch.config import Config
    from anime_recommendations_tpu_torch.data import synthetic as synth
    from anime_recommendations_tpu_torch.data.catalog import Catalog
    from anime_recommendations_tpu_torch.data.preprocess import preprocess_ratings
    from anime_recommendations_tpu_torch.data.vocab import build_vocab, encode_frame
    from anime_recommendations_tpu_torch.models.two_tower import init_params
    from anime_recommendations_tpu_torch.recommend.context import RecContext
    from anime_recommendations_tpu_torch.serve.api import Engine

    frames = synth.synth_ratings(n_users=s.serve_users, n_anime=s.serve_anime,
                                 n_interactions=s.serve_interactions, seed=SERVE_SEED)
    cat = synth.synth_anime_catalog(n_anime=s.serve_anime, seed=SERVE_SEED)
    syn = synth.synth_synopses(cat, seed=SERVE_SEED)
    clean, _ = preprocess_ratings(frames, num_reviews=40)
    vocab = build_vocab(clean)
    encoded = encode_frame(clean, vocab)
    catalog = Catalog.from_frames(cat, syn)
    model = init_params(vocab.n_users, vocab.n_anime, s.serve_d, generator=_gen(9), device=dev)
    ctx = RecContext.build(model, vocab, catalog, encoded, device=dev)
    uid, other = int(vocab.user_ids[3]), int(vocab.user_ids[7])
    names = catalog.anime["Name"]
    aname = names.iloc[5]

    engine = Engine(ctx, Config())
    # Warm with other queries, so "cold" is a cache miss, not a first call.
    engine.similar_anime(names.iloc[9], k=10)
    engine.user_recs(other, k=10)
    for fn_name, call in (("similar_anime", lambda: engine.similar_anime(aname, k=10)),
                          ("user_recs", lambda: engine.user_recs(uid, k=10))):
        t0 = time.perf_counter()
        call()
        details[f"serve_{fn_name}_cold_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
        details[f"serve_{fn_name}_warm_ms"] = _timed_best(call, 5)
    info = engine.cache_info()
    if "hits" in info:
        details["serve_cache_hits"] = info["hits"]
        details["serve_cache_misses"] = info["misses"]

    engine = Engine(ctx, Config())
    engine.similar_anime(names.iloc[9], k=10)
    engine.user_recs(other, k=10)
    engine.model_recs(other, k=10)
    for fn_name, call in (
            ("similar_anime", lambda: engine.similar_anime(aname, k=10)),
            ("user_recs", lambda: engine.user_recs(uid, k=10)),
            ("model_recs", lambda: engine.model_recs(uid, k=10)),
            ("similar_users_scan", lambda: engine._similar_users_scan(uid, 30)),
            ("user_prefs", lambda: engine.user_prefs(uid))):
        call()
        details[f"serve_{fn_name}_host_ms"] = _timed_best(call, 7)


# ---- the suite ---------------------------------------------------------------------


def _device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench --device cuda: torch.cuda.is_available() is False "
                               "(--device cpu runs the kernels' plain versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"bench: unsupported device {device!r}")
    return dev


@contextlib.contextmanager
def _section(label: str):
    t0 = time.perf_counter()
    yield
    print(f"[bench] {label}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)


def run(sizes: BenchSizes = FULL, device: str = "cuda") -> dict:
    """The eleven sections in bench.py's order; returns the result line."""
    dev = _device(device)
    if dev.type == "cuda":
        from anime_recommendations_tpu_torch.utils.profiling import start_profiler

        torch.cuda.set_device(dev)
        start_profiler()
    s, details = sizes, {"device": card(dev), "backend": dev.type}
    rng = np.random.default_rng(0)
    with _section("1 per-step training"):
        _train_per_step(rng, s, dev, details)
    with _section("2 epochs"):
        examples_per_sec = _train_epochs(rng, s, dev, details)
    with _section("3 epochs at 350k users"):
        _train_350k(rng, s, dev, details)
    with _section("4-5 routed"), one_rank_group(dev):
        _train_routed(rng, s, dev, details)
    with _section("6 retrieval"):
        tables = _retrieval(rng, s, dev, details)
    with _section("7 IVF"):
        _ivf(rng, s, dev, details)
    with _section("8-9 scoring, oracle"):
        _scoring(rng, s, dev, details, tables)
        _oracle_overlap(s, dev, details, tables.w)
    del tables
    with _section("10 trained tables"):
        _trained(s, dev, details)
    with _section("11 serving"):
        _serving(s, dev, details)
    return {"metric": "train_examples_per_sec", "value": round(examples_per_sec),
            "unit": "examples/s", "vs_baseline": None, "details": details}


def main(sizes: BenchSizes = FULL, device: str = "cuda") -> dict:
    """Run the suite: the result line alone on stdout; the launches line and
    everything else the run prints on stderr."""
    _kernels.launches.clear()
    with contextlib.redirect_stdout(sys.stderr):
        result = run(sizes, device)
        print(f"[bench] launches {json.dumps(dict(_kernels.launches))}", flush=True)
    print(json.dumps(result), flush=True)
    return result
