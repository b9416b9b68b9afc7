#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; it builds the port's kernels from the
checkout itself. It fails (exit code other than 0, no result line) when
CUDA is unavailable or when it runs outside a checkout of the repository.

  phase 1  device and build: card name and power limit, torch/CUDA/nvcc
           versions; every kernel built at once (one nvcc per source, all
           started together) and loaded.
  phase 2  each serving kernel against its plain PyTorch version on the
           card at the shapes the serving path gives it (91,641 x 128 user
           table, 17,560 x 128 anime table; 1 to 256 queries; with and
           without head, mask and exclude), against a dense full-score
           oracle, and timed: the kernel's device time under torch.profiler
           (20 calls after warm-up; every kernel counted as its mean
           recorded time times its launches per call, and the launch records
           the profiler lost counted) against its plain version's, the
           CUDA-event median of a call beside it, and the share of the
           card's bound (bytes at 3.35 TB/s or operations at the peak of
           the type the kernel computes in) the kernel reaches:
             packed_topk (K2; k2_cases), f32 and bf16 tables, both of its
               kernels: packed_topk_kernel for one query, and from
               ops/topk.TF32_MIN_Q = 2 queries packed_topk_mma_kernel on
               the tensor cores (TF32 for f32 tables, in the plain version
               too), a k deep enough to drive top_r above 64;
             packed_topk_int8 (K2q), int8 tables, keys bit-equal to the
               plain version's without a head, a k that drives top_r above
               64;
             exact_topk (K3; K3_CASES), f32 and bf16 tables, 1 to 256
               queries, k = 10 and 600;
             l2_normalize (K4), the raw embedding tables, f32 and bf16 out.
  phase 3  the slice end to end at reference scale: synthetic data of
           ~91,641 users x 17,560 anime x 3M ratings made from a seed, D =
           128 parameters from a seed written in the JAX package's .npz
           format and loaded from an artifact store through the port's
           entry points; four contexts on the card (f32, bf16, int8 and an
           f32 context whose scans are exact), and every endpoint of the
           HTTP server answered by each and checked against a dense oracle
           on the card. Launch counters are reset before this phase: every
           scanning endpoint must launch its context's scan kernel
           (packed_topk or packed_topk_mma, packed_topk_int8, exact_topk;
           each of them at least once), and every context
           build l2_normalize twice (the anime and the user table).
  phase 4  the fused sparse-Adam kernel (K1: its first pass over tiles of
           sorted positions, fused_adam_tiles_kernel, then the update) and its
           variant that also gathers the next batch's rows (K5: the first
           pass, the update, the gather's second pass) against their plain
           PyTorch versions on the card at the training shapes: the 91,641 x
           128 user table and the 17,560 x 128 anime table (neither a
           multiple of the 32-row block), a 10,000-row batch of the synthetic
           ratings' ids (their real skew), a case with every id the same,
           bench.py:570-692's skewed ids (_zipf_ratings' first 10,000), f32
           moments and bf16 moments with stochastic rounding. K1: rows the
           batch hits at most once must match bit for bit (W', mu', nu'), hot
           rows within the stated tolerances, every row bit for bit the plain
           version fed the kernel's own tile order, the first pass's tile
           sums its plain version's, and the bf16 stores must round the other
           way than round-to-nearest about a quarter of the time. K5, with
           the next 10,000 ids of the same data as next ids (duplicates among
           them) and a few ids outside the table: its tables and sumsq must
           equal K1's on the same inputs bit for bit, its rows equal
           W'[next_ids] exactly (zero outside), the second pass its plain
           version's, and both are held to the plain version as K1 is. Each
           case's launches by kernel, the device time of its kernels and of
           each one, its plain version's (torch.profiler, 20 calls after
           warm-up), bytes moved / time against 3.35 TB/s, its share of the
           bound, and each call's CUDA-event time.
  phase 5  training end to end at full width: PipelineRunner.step_train on
           phase 3's store, 2 epochs of 297 batches of 10,000 rows, once per
           optimizer (adam, lazy_adam, fused_adam, fused_adam_bf16m; one
           seed, the device loop, whose fused epochs are the software-
           pipelined loop). Launch counters are reset before it: each fused
           step must launch K1 twice, adam and lazy_adam never. The fused
           histories must track the dense one, lazy_adam's training loss must
           fall from epoch 1 to 2, the bf16m state must hold bf16 table
           moments, and the trained store must serve every endpoint through
           the HTTP server in agreement with the dense oracle. Then one more
           timed epoch per optimizer gives ms per step and examples per
           second, and 10 steps under torch.profiler the device-busy time;
           the idle share is given under the profiler and against the timed
           epoch's ms/step.
  phase 6  K5 on the training path at full width: one epoch (297 steps of
           10,000) of the pipelined fused loop with the gather inside the
           kernel (kernel_gather=True) and one with the gather after it, from
           the same state and the same shuffle, for fused_adam and
           fused_adam_bf16m. Counters are reset before each: the first must
           launch fused_adam_gather and its second pass 594 times and
           fused_adam never, the second the reverse, both the first pass 594
           times; losses, mses and the final tables and moments must be
           equal bit for bit. ms/step, profiled device time and idle share as
           in phase 5, and the first epoch's minus the second's. Then the
           convergence harness at its CI scale on the
           card for every optimizer: adam, fused_adam and fused_adam_bf16m
           must meet tests/test_convergence.py's thresholds, lazy_adam's best
           validation MSE must fall below its first epoch's.
  phase 7  the routed, row-sharded trainer (parallel/) on an NCCL process
           group of world size 1 (tcp://127.0.0.1, a free port; a failure to
           set it up fails the run), and K1's dense-gradient branch.
           7a: right after phase 4 (later, after phase 6's runs and once
           the group exists, torch.profiler sessions lose launch records),
           K1 with a dense [N, D] gradient from a seed (its kernel
           fused_adam_dense_kernel) on phase 4's tables and batches (the
           skewed anime batch too), f32 and bf16 moments with stochastic
           rounding, against its plain version (rows hit at most once bit for
           bit, hot rows at phase 4's tolerances, every row bit for bit in
           the kernel's tile order) and with a precomputed stable order bit
           for bit the call without; then the routed trainer's own receipts at capacity
           512 (route_grad_rows: staged receipts plus the dense overflow of
           rounds past 4) with receipt_sort_order's order, bit for bit the
           call without and the plain version. Timed as phase 4.
           7b: PipelineRunner.step_train on phase 3's store with
           parallel.capacity set (the routed trainer), one epoch of 297
           batches of 10,000 per optimizer at 10,000 slots (the default
           capacity at world size 1), then fused_adam and fused_adam_bf16m at 512,
           where both tables take more than 4 rounds (printed): counters reset
           before each; the default fused runs must launch K1 twice a step and
           its dense kernel never, the capped ones the reverse; every history
           must track phase 5's first epoch of the same optimizer within
           phase 5's tolerances. Then 20 steps, each from one state at both
           capacities, agree (loss 1e-6 relative, tables 1e-6 absolute +
           1e-5 relative: tests/test_parallel.py's), and one timed routed
           epoch per optimizer (and the capped fused one) gives ms per step
           beside phase 5's, with 10 steps under torch.profiler.
  phase 8  a table trained on skewed ids, served: bench.py:570-692's
           protocol at 91,641 users (6 fused_adam epochs at lr 3e-4 over 2M
           ratings of pareto-skewed ids, through K1; ms per step), then the
           256 hottest users' top-10 on the shuffled user table against the
           exact scan: f32 at Q=256 (tensor cores) and one query at a time,
           bf16 against the f32 and the bf16 exact scans, int8 at Q=256 and
           Q=8, beside BENCH_r05's records (phase_trained says which must
           reach them).

The last lines are the card line, a JSON line of kernel results (each
kernel's launches on its path, largest error against its plain version, its
time, the plain version's, the least time the card could take for the work
at 3.35 TB/s and the data sheet's peak rates, and one PyTorch call's time
where one computes the same function; K1's, its dense branch's and K5's
times are those of all the kernels a call launches, their passes included,
which are listed on their own too), and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

N_USERS, N_ANIME, N_RATINGS, D = 91_641, 17_560, 3_000_000, 128
SEED = 7
TIMED_RUNS = 20
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# Peak operations per second by type (H100 SXM data sheet, dense): f32
# outside the tensor cores; tf32, bf16 and int8 on the tensor cores.
PEAK_OPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12}
BATCH = 10_000
TRAIN_EPOCHS = 2
DEVICE = "cuda"   # of the training phases (4 to 6)


# ---- phase 1 -------------------------------------------------------------------

def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from anime_recommendations_tpu_torch.ops import _kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    nvcc = subprocess.run([_kernels.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[phase 1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvcc: {nvcc}; devices: {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # the exact stages are f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    names = list(_kernels.SOURCES)
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc process per source
        list(pool.map(_kernels.build, names))
    for name in names:
        _kernels.library(name)
    print(f"[phase 1] built and loaded {', '.join(names)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    start_profiler()
    return card


def start_profiler() -> None:
    """One short torch.profiler session, first thing in the process (set up
    first after phase 3's server threads had launched work, the profiler
    recorded no kernels in this script), and a check of the name of the
    busy-wait kernel that frames _profiled's sessions."""
    import torch

    if not _profiled(lambda: torch.ones(1 << 20, device="cuda").sum(), reps=1)["device_ms"] > 0:
        raise AssertionError("torch.profiler records no device time on this machine")
    # A session loses its records now and then (_profiled): try again.
    for _ in range(PROFILER_SESSIONS):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(FRAME_CYCLES // 100)
            torch.cuda.synchronize()
        keys = [e.key for e in prof.key_averages()]
        if any("spin_kernel" in k for k in keys):
            return
        print(f"[profiler] the framing session recorded {keys}", flush=True)
    raise AssertionError("the busy-wait kernel framing profiler sessions is not spin_kernel")


# ---- phase 2 -------------------------------------------------------------------

# Phase 2's float scan cases, K2 (k2_cases) and K3 (K3_CASES): (name, table,
# dtype, Q, k, features); features "exclude" (each query's own row, from the
# user table) or "head_mask" (the sigmoid head and an anime mask keeping
# ~80 % of the rows). tools/scan_kernels.py times the same cases.
DTYPES = {"f32": "float32", "bf16": "bfloat16"}
# K2's launch counters: the streaming branch (one query) and the
# tensor-core branch (more), as ops/topk._packed_candidates_cuda counts them.
K2_COUNTERS = ("packed_topk", "packed_topk_mma")


def _k2_launches() -> int:
    from anime_recommendations_tpu_torch.ops import _kernels

    return sum(_kernels.launches[c] for c in K2_COUNTERS)


def _named(cases) -> tuple:
    named = {}
    for which, dtype, q, k, features in cases:
        name = f"{which}_{dtype}_q{q}_{features}" + ("" if k == 10 else f"_k{k}")
        named[name] = (name, which, dtype, q, k, features)
    return tuple(named.values())


def k2_cases() -> tuple:
    """K2's cases: 1 to 256 queries, both sides of the tensor-core threshold
    (ops/topk.TF32_MIN_Q), f32 and bf16, and a k deep enough to drive top_r
    above 64 (model_recs_batch asks for n_recs + max watched)."""
    from anime_recommendations_tpu_torch.ops.topk import TF32_MIN_Q

    return _named([("users", "f32", q, 10, "exclude")
                   for q in (1, 8, TF32_MIN_Q - 1, TF32_MIN_Q, 64, 256)]
                  + [("users", "bf16", q, 10, "exclude") for q in (1, 256)]
                  + [("anime", "f32", q, 10, "head_mask") for q in (1, 64, 256)]
                  + [("anime", "f32", 16, 600, "head_mask")])


K3_CASES = _named([("users", "f32", q, 10, "exclude") for q in (1, 8, 256)]
                  + [("anime", "f32", q, k, "head_mask")
                     for q, k in ((1, 10), (64, 10), (256, 10), (16, 600))]
                  + [("users", "bf16", q, 10, "exclude") for q in (8, 256)])


def _case_inputs(rng, tables, case, head, anime_mask):
    """(table, queries, kwargs) of a phase-2 case: queries are user rows."""
    import torch

    _, which, dtype, q, _, features = case
    table = tables[which].to(getattr(torch, DTYPES[dtype]))
    idx = torch.from_numpy(rng.choice(N_USERS, size=q, replace=False)).to(table.device)
    kw = dict(exclude=idx) if features == "exclude" else dict(mask=anime_mask, head=head)
    return table, tables["users"][idx], kw


def _normal_table(rng, n, dtype, device):
    import torch

    w = rng.standard_normal((n, D), dtype=np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    return torch.from_numpy(w).to(device=device, dtype=dtype)


def _oracle_topk(table, queries, k, mask=None, exclude=None, head=None):
    """Dense full-score top-k in f32 on the table's device."""
    import torch

    s = queries.float() @ table.float().T
    if head is not None:
        s = torch.sigmoid(head[0] * s + head[1])
    if mask is not None:
        s = s.masked_fill(~mask[None, :], -torch.inf)
    if exclude is not None:
        rows = torch.arange(table.shape[0], device=table.device)
        s = s.masked_fill(rows[None, :] == exclude[:, None], -torch.inf)
    return s.topk(k, dim=1)


def _nbytes(*tensors) -> int:
    """Bytes of the given tensors (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _scan_bound(table_bytes, queries, mask, exclude, out_bytes, n, d, kind="f32") -> dict:
    """_bound of one stage-1 or exact scan: the table, the queries, mask and
    exclude read once, the candidates written once, 2 n d Q operations."""
    return _bound(table_bytes + _nbytes(queries, mask, exclude) + out_bytes,
                  2 * n * d * queries.shape[0], kind)


def _bound(bytes_moved: float, ops: float, kind: str = "f32") -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over 3.35 TB/s
    and its operations over the peak rate of their type."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _median_ms(fn) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


PROFILER_SESSIONS = 5
# A busy-wait kernel of this many clock cycles (about 10 ms on an H100)
# opens and closes every profiler session: see _profiled.
FRAME_CYCLES = 20_000_000


def _profiled(fn, reps: int = TIMED_RUNS, match=None) -> dict:
    """torch.profiler over ``reps`` calls of fn after 3 warm-up calls: wall ms
    per call (host clock to a synchronize), device-busy ms per call, the idle
    share, device ms per call by kernel, the sessions it took and the launch
    records they lost, and (``match``, a name or a tuple of names) the device
    ms per call of the kernels whose names hold one of them (fn launches each
    once a call), their sum and their records.

    Every kernel is counted by one rule: its mean recorded duration times
    its launches per call (its records over ``reps``, rounded). On an H100
    host a session lost every record now and then, and in some processes
    one record of a small kernel (an arange, a dtype copy) in every session.
    So a busy-wait kernel (FRAME_CYCLES, excluded from every number) opens
    and closes each session; the records lost (launches per call times
    ``reps``, less the records) are counted; and a session with no records,
    a matched name with no kernel, or a matched kernel with fewer than
    ``reps`` - 1 records, is profiled again, at most PROFILER_SESSIONS times
    in all, and then the run fails."""
    import torch

    names = (match,) if isinstance(match, str) else tuple(match or ())
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for session in range(1, PROFILER_SESSIONS + 1):
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(FRAME_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
            torch.cuda._sleep(FRAME_CYCLES)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0 and "spin_kernel" not in e.key]
        hits = [e for e in events if any(m in e.key for m in names)]
        # Some processes lose one record of one kernel in every session (an
        # arange in phase 4; K1's dense kernel in phase 7a): the mean of the
        # matched kernel's other reps - 1 records stands for it.
        if (events and all(any(m in e.key for e in hits) for m in names)
                and all(reps - 1 <= e.count <= reps for e in hits)):
            break
        print(f"[profiler] session {session} of {reps} calls recorded "
              f"{ {e.key[:60]: e.count for e in hits} } of {names}, {len(events)} kernels",
              flush=True)
    else:
        raise AssertionError(f"torch.profiler lost records in {PROFILER_SESSIONS} sessions")
    per_call = {e.key: e.self_device_time_total / e.count * round(e.count / reps) / 1e3
                for e in events}
    lost = sum(abs(round(e.count / reps) * reps - e.count) for e in events)
    if lost:
        print(f"[profiler] {lost} launch records lost: "
              f"{ {e.key[:60]: e.count for e in events} }", flush=True)
    busy = sum(per_call.values())
    top = sorted(per_call.items(), key=lambda kv: kv[1], reverse=True)
    out = {"wall_ms": wall, "device_ms": busy, "idle_share": 1 - busy / wall,
           "by_kernel": {k[:70]: v for k, v in top[:8]}, "sessions": session,
           "records_lost": lost}
    if names:
        out["match_ms"] = sum(per_call[e.key] for e in hits)
        out["match_launches"] = sum(e.count for e in hits)
        out["match_by_kernel"] = {_kernel_name(e.key): per_call[e.key] for e in hits}
    return out


def _kernel_name(key: str) -> str:
    """A profiler key's kernel name without its namespace, template arguments
    and parameters, e.g. fused_adam_kernel."""
    head = key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return head.split()[-1].split("::")[-1]


def _row_scores(table, queries, idx, head=None):
    """f64 score of row ``idx[q, j]`` for query ``q`` ([Q, k]), through the head."""
    import torch

    s = torch.einsum("qd,qkd->qk", queries.double(), table.double()[idx])
    return s if head is None else torch.sigmoid(head[0].double() * s + head[1].double())


def _decoded(keys):
    """Stage-1 score of each packed key (lane bits cleared, bias removed)."""
    import torch

    return (keys & ~511).view(torch.float32) - 2.0


def _check_case(card, name, table, queries, k, *, mask=None, exclude=None, head=None):
    import torch

    from anime_recommendations_tpu_torch.ops import _kernels, topk

    tol = 1e-5 if table.dtype == torch.float32 else 1e-2
    qt = queries.to(table.dtype).contiguous()
    r = topk.top_r_policy(k, table.shape[0])
    qn = queries.shape[0]
    big = qn >= topk.TF32_MIN_Q
    counter = K2_COUNTERS[big]
    before = _kernels.launches[counter]
    v, i = topk.masked_topk(table, queries, k, mask=mask, exclude=exclude, head=head)
    torch.cuda.synchronize()
    if _kernels.launches[counter] <= before:
        raise AssertionError(f"{name}: masked_topk did not launch the kernel")
    vp, ip = topk.two_stage_topk(topk._packed_candidates_plain, table, queries, k,
                                 mask=mask, exclude=exclude, head=head)
    err = float((v - vp).abs().max())
    if not err <= tol:
        raise AssertionError(f"{name}: values differ from the plain version by {err}")
    # Indices may differ only where the two rows' true scores tie within 1e-6.
    if bool((i < 0).any() or (ip < 0).any()):
        raise AssertionError(f"{name}: dead slots in a table with enough live rows")
    differ = i != ip
    gap = (_row_scores(table, queries, i, head) - _row_scores(table, queries, ip, head)).abs()
    if bool((differ & (gap > 1e-6)).any()):
        raise AssertionError(f"{name}: indices differ from the plain version")
    if not bool(torch.isfinite(v).all()) or v.shape != (queries.shape[0], k):
        raise AssertionError(f"{name}: non-finite values or shape {tuple(v.shape)}")
    _, oi = _oracle_topk(table, queries, k, mask, exclude, head)
    overlap = np.mean([len(set(a) & set(b)) / k
                       for a, b in zip(i.tolist(), oi.tolist())])
    if overlap != 1.0:
        raise AssertionError(f"{name}: overlap with the dense oracle {overlap}")
    # Stage 1 alone: the kernel's keys against the plain keys (the same
    # precision rule on both sides): the same live slots, one key step.
    args = (table, qt, r, mask, exclude, head)
    kk = topk._packed_candidates_cuda(*args)
    kp = topk._packed_candidates_plain(*args)
    live = kp > 0
    if not torch.equal(kk > 0, live):
        raise AssertionError(f"{name}: stage-1 keys differ in which slots are live")
    key_err = float((_decoded(kk) - _decoded(kp)).abs()[live].max())
    if not key_err <= 1.3e-4:
        raise AssertionError(f"{name}: stage-1 keys differ by {key_err}")
    row = dict(card=card, case=name, n=table.shape[0], q=qn, dtype=str(table.dtype),
               k=k, top_r=r, branch="tensor_core" if big else "small_q", max_abs_err=err,
               key_err=key_err, overlap=overlap)
    # ms: packed_topk's device time (torch.profiler); event_ms: one call's
    # CUDA-event time, launch included.
    row |= _timing(lambda: topk._packed_candidates_cuda(*args),
                   lambda: topk._packed_candidates_plain(*args), f"{counter}_kernel")
    row["masked_topk_event_ms"] = _median_ms(lambda: topk.masked_topk(
        table, queries, k, mask=mask, exclude=exclude, head=head))
    row["masked_topk_plain_event_ms"] = _median_ms(lambda: topk.two_stage_topk(
        topk._packed_candidates_plain, table, queries, k, mask=mask, exclude=exclude,
        head=head))
    # The table is read once per query tile (one query below the threshold,
    # 64 from it); tiles of one group run side by side and may share its
    # rows through L2.
    row["table_reads"] = -(-qn // 64) if big else qn
    kind = "f32" if not big else ("tf32" if table.dtype == torch.float32 else "bf16")
    row |= _scan_bound(_nbytes(table), qt, mask, exclude, _nbytes(kk), *table.shape, kind=kind)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print("[phase 2] " + json.dumps(row), flush=True)
    return row


def phase_kernels(card: str) -> list[dict]:
    import torch

    from anime_recommendations_tpu_torch.ops import topk

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    tables = {"users": _normal_table(rng, N_USERS, torch.float32, dev),
              "anime": _normal_table(rng, N_ANIME, torch.float32, dev)}
    head = torch.tensor([4.3, -0.7], device=dev)
    anime_mask = torch.from_numpy(rng.uniform(size=N_ANIME) > 0.2).to(dev)
    rows = []
    for case in k2_cases():
        table, queries, kw = _case_inputs(rng, tables, case, head, anime_mask)
        rows.append(_check_case(card, case[0], table, queries, case[4], **kw))
        if case[0] == "users_f32_q256_exclude":
            # The depth comes from ops/topk.top_r_policy (4 on this table at
            # k = 10), where the JAX package takes 2 above 64 queries: what
            # that depth costs.
            qt, idx = queries.contiguous(), kw["exclude"]
            shallow = (lambda: topk._packed_candidates_cuda(tables["users"], qt, 2, None,
                                                            idx, None))
            ms2 = _profiled(shallow, match="packed_topk_mma_kernel")["match_ms"]
            print(f"[phase 2] users_f32_q256_exclude stage 1 at top_r=2: {ms2} ms device "
                  f"time, {_median_ms(shallow)} ms CUDA-event time ({card})", flush=True)
    if max(r["top_r"] for r in rows) <= 64:
        raise AssertionError("no phase-2 case drove top_r above 64")
    if {r["branch"] for r in rows} != {"small_q", "tensor_core"}:
        raise AssertionError("phase 2 did not drive both K2 branches")
    return rows


def _timing(fn, plain_fn, kernel) -> dict:
    """The kernel's device time per call (torch.profiler, the kernels named
    by ``kernel``, a name or a tuple, alone, every launch recorded; each one's
    too), its plain version's (all of its
    kernels, every launch recorded), the launches and sessions behind each,
    and both medians of CUDA-event times (launch overhead included)."""
    prof, plain = _profiled(fn, match=kernel), _profiled(plain_fn)
    return dict(ms=prof["match_ms"], by_kernel_ms=prof["match_by_kernel"],
                match_launches=prof["match_launches"],
                sessions=prof["sessions"], plain_ms=plain["device_ms"],
                plain_sessions=plain["sessions"], plain_records_lost=plain["records_lost"],
                event_ms=_median_ms(fn), plain_event_ms=_median_ms(plain_fn))


def _check_ties(name, table, queries, i, ip, head, exact=False):
    """Indices equal, except where the two rows' true scores tie within
    1e-6; no dead slot (every case has enough live rows)."""
    if bool((i < 0).any() or (ip < 0).any()):
        raise AssertionError(f"{name}: dead slots in a table with enough live rows")
    gap = (_row_scores(table, queries, i, head) - _row_scores(table, queries, ip, head)).abs()
    if bool(((i != ip) & (gap > 1e-6)).any()):
        raise AssertionError(f"{name}: indices differ from the plain version")


def _oracle_overlap(name, table, queries, k, i, mask, exclude, head) -> float:
    """Share of the dense oracle's top-k rows returned. A row may be missed
    only for another whose true score ties with it within 1e-6."""
    ov, oi = _oracle_topk(table, queries, k, mask, exclude, head)
    overlap = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(i.tolist(), oi.tolist())]))
    if overlap != 1.0:
        got = _row_scores(table, queries, i, head)
        kth = got.min(dim=1).values
        missed = ~_isin(oi, i)
        if bool((missed & ((ov.double() - kth[:, None]).abs() > 1e-6)).any()):
            raise AssertionError(f"{name}: overlap with the dense oracle {overlap}")
    return overlap


def _isin(a, b):
    """[Q, k] bool: a[q, j] is among b[q, :]."""
    return (a[:, :, None] == b[:, None, :]).any(dim=2)


def _normalize_case(card, name, emb, out_dtype) -> dict:
    """K4 at a table build's shapes: the kernel against its plain version."""
    import torch

    from anime_recommendations_tpu_torch.models.two_tower import TF_L2_NORM_EPS
    from anime_recommendations_tpu_torch.ops import _kernels, normalize

    eps = TF_L2_NORM_EPS
    before = _kernels.launches["l2_normalize"]
    got = normalize.l2_normalize_rows(emb, eps=eps, out_dtype=out_dtype)
    if _kernels.launches["l2_normalize"] != before + 1:
        raise AssertionError(f"{name}: l2_normalize_rows did not launch the kernel")
    want = normalize._l2_normalize_rows_plain(emb, eps, out_dtype)
    torch.cuda.synchronize()
    zero = ~emb.any(dim=1)
    if not bool(zero.any()) or bool(got[zero].any()):
        raise AssertionError(f"{name}: a zero row did not stay zero")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()) or got.shape != emb.shape or got.dtype != out_dtype:
        raise AssertionError(f"{name}: non-finite output, or shape/dtype {got.shape} {got.dtype}")
    # f32: 1e-6 relative (rsqrtf is not correctly rounded); bf16: one ulp
    # (two f32 values a few ulp apart may round to either neighbour).
    tol = 1e-6 * w.abs() if out_dtype == torch.float32 else _ulp_bf16(w)
    err = (g - w).abs()
    if bool((err > tol).any()):
        raise AssertionError(f"{name}: differs from the plain version by {float(err.max())}")
    row = dict(card=card, case=name, n=emb.shape[0], out_dtype=str(out_dtype),
               max_abs_err=float(err.max()), bit_equal_share=float((g == w).float().mean()))
    row |= _timing(lambda: normalize._l2_normalize_rows_cuda(emb, eps, out_dtype),
                   lambda: normalize._l2_normalize_rows_plain(emb, eps, out_dtype),
                   "l2_normalize_kernel")
    row["bytes_moved"] = emb.numel() * (4 + got.element_size())
    row["hbm_share"] = row["bytes_moved"] / (row["ms"] * 1e-3) / HBM_BYTES_PER_S
    row |= _bound(row["bytes_moved"], 3 * emb.numel())   # square, add; multiply
    # One PyTorch call of the same function, f32 out: F.normalize clamps the
    # norm, K4 the squared norm, so its eps is the square root of K4's.
    row["library_ms"] = (_profiled(lambda: torch.nn.functional.normalize(emb, dim=1, eps=eps ** 0.5))
                         ["device_ms"] if out_dtype == torch.float32 else None)
    print("[phase 2] " + json.dumps(row), flush=True)
    return row


def _int8_case(card, name, qt, queries, k, *, mask=None, exclude=None, head=None) -> dict:
    """K2q: quantized_topk against its plain version (the same two stages
    with the plain stage 1) and the dense oracle; stage-1 keys alone."""
    import torch

    from anime_recommendations_tpu_torch.ops import _kernels, quantized, topk

    n = qt.q.shape[0]
    r = topk.top_r_policy(k, n)
    before = _kernels.launches["packed_topk_int8"]
    v, i = quantized.quantized_topk(qt, queries, k, mask=mask, exclude=exclude, head=head)
    torch.cuda.synchronize()
    if _kernels.launches["packed_topk_int8"] <= before:
        raise AssertionError(f"{name}: quantized_topk did not launch the kernel")
    plain = functools.partial(quantized.quantized_two_stage, topk._packed_candidates_plain, qt,
                              queries, k, mask=mask, exclude=exclude, head=head)
    vp, ip = plain()
    err = float((v - vp).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"{name}: values differ from the plain version by {err}")
    if not bool(torch.isfinite(v).all()) or v.shape != (queries.shape[0], k):
        raise AssertionError(f"{name}: non-finite values or shape {tuple(v.shape)}")
    _check_ties(name, qt.f32, queries, i, ip, head)
    overlap = _oracle_overlap(name, qt.f32, queries, k, i, mask, exclude, head)
    # Stage 1 alone: bit-equal keys without a head, one key step with it.
    q_int, q_scale = quantized._quantize(queries.float())
    args = (qt.q, q_int.contiguous(), r, mask, exclude, head)
    kk = topk._packed_candidates_int8_cuda(*args, q_scale, qt.scale)
    kp = topk._packed_candidates_plain(*args, q_scale, qt.scale)
    if head is None:
        if not torch.equal(kk, kp):
            raise AssertionError(f"{name}: stage-1 keys are not bit-equal to the plain version's")
        key_err = 0.0
    else:
        live = kp > 0
        if not torch.equal(kk > 0, live):
            raise AssertionError(f"{name}: stage-1 keys differ in which rows are live")
        key_err = float((_decoded(kk) - _decoded(kp)).abs()[live].max())
        if not key_err <= 1.3e-4:
            raise AssertionError(f"{name}: stage-1 keys differ by {key_err}")
    row = dict(card=card, case=name, n=n, q=queries.shape[0], k=k, top_r=r, max_abs_err=err,
               key_err=key_err, overlap=overlap)
    row |= _timing(lambda: topk._packed_candidates_int8_cuda(*args, q_scale, qt.scale),
                   lambda: topk._packed_candidates_plain(*args, q_scale, qt.scale),
                   "packed_topk_int8_kernel")
    row["quantized_topk_ms"] = _median_ms(lambda: quantized.quantized_topk(
        qt, queries, k, mask=mask, exclude=exclude, head=head))
    row["quantized_topk_plain_ms"] = _median_ms(plain)
    # The table (int8 rows and f32 row scales) is read once per 8-query tile.
    row["bytes_read"] = (qt.q.numel() + 4 * n) * -(-queries.shape[0] // 8)
    row["hbm_share"] = row["bytes_read"] / (row["ms"] * 1e-3) / HBM_BYTES_PER_S
    row |= _scan_bound(_nbytes(qt.q, qt.scale, q_scale), q_int, mask, exclude, _nbytes(kk),
                       *qt.q.shape, kind="int8")
    print("[phase 2] " + json.dumps(row), flush=True)
    return row


def _exact_case(card, name, table, queries, k, *, mask=None, exclude=None, head=None) -> dict:
    """K3: masked_topk(exact_scan=True) against its plain version and the
    dense oracle."""
    import torch

    from anime_recommendations_tpu_torch.ops import _kernels, topk

    tq = queries.to(table.dtype).contiguous()
    before = _kernels.launches["exact_topk"]
    v, i = topk.masked_topk(table, queries, k, mask=mask, exclude=exclude, head=head,
                            exact_scan=True)
    torch.cuda.synchronize()
    if _kernels.launches["exact_topk"] != before + 1:
        raise AssertionError(f"{name}: masked_topk(exact_scan=True) did not launch the kernel")
    vp, ip = topk._exact_scan_plain(table, tq, k, mask, exclude, head)
    err = float((v - vp).abs().max())
    if not bool(((v - vp).abs() <= 1e-6 * vp.abs() + 1e-7).all()):
        raise AssertionError(f"{name}: values differ from the plain version by {err}")
    if not bool(torch.isfinite(v).all()) or v.shape != (queries.shape[0], k):
        raise AssertionError(f"{name}: non-finite values or shape {tuple(v.shape)}")
    _check_ties(name, table, tq, i, ip, head)
    overlap = _oracle_overlap(name, table, tq, k, i, mask, exclude, head)
    row = dict(card=card, case=name, n=table.shape[0], q=queries.shape[0], dtype=str(table.dtype),
               k=k, max_abs_err=err, overlap=overlap)
    row |= _timing(lambda: topk._exact_scan_cuda(table, tq, k, mask, exclude, head),
                   lambda: topk._exact_scan_plain(table, tq, k, mask, exclude, head),
                   "exact_topk_kernel")
    # The table is read once per query tile of 1, 8 or 32 queries, as the
    # kernel's own rule picks it (tiles of one chunk run side by side and may
    # share its rows through L2).
    qn = queries.shape[0]
    row["tile"] = _kernels.library("exact_topk").exact_topk_query_tile(table.shape[0], qn)
    row["table_reads"] = -(-qn // row["tile"])
    n_chunks, kc = -(-table.shape[0] // 512), min(k, 512)
    row |= _scan_bound(_nbytes(table), tq, mask, exclude, n_chunks * kc * tq.shape[0] * 8,
                       *table.shape)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print("[phase 2] " + json.dumps(row), flush=True)
    return row


def phase_new_kernels(card: str) -> dict[str, list[dict]]:
    """K4, K2q and K3 at the serving path's shapes."""
    import torch

    from anime_recommendations_tpu_torch.ops import quantized

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    out = {"l2_normalize": [], "packed_topk_int8": [], "exact_topk": []}
    # K4 on the raw embedding tables a context build normalizes (one zero row each).
    for table, n in (("users", N_USERS), ("anime", N_ANIME)):
        emb = rng.uniform(-0.05, 0.05, (n, D)).astype(np.float32)
        emb[n // 3] = 0.0
        emb = torch.from_numpy(emb).to(dev)
        for out_dtype in ((torch.float32, torch.bfloat16) if table == "users" else (torch.float32,)):
            tag = "f32" if out_dtype == torch.float32 else "bf16"
            out["l2_normalize"].append(_normalize_case(card, f"{table}_f32_to_{tag}", emb, out_dtype))
    users = _normal_table(rng, N_USERS, torch.float32, dev)
    anime = _normal_table(rng, N_ANIME, torch.float32, dev)
    head = torch.tensor([4.3, -0.7], device=dev)
    anime_mask = torch.from_numpy(rng.uniform(size=N_ANIME) > 0.2).to(dev)

    def pick(n, q):
        return torch.from_numpy(rng.choice(n, size=q, replace=False)).to(dev)

    users_q, anime_q = quantized.quantize_rows(users), quantized.quantize_rows(anime)
    for q in (1, 8, 256):
        idx = pick(N_USERS, q)
        out["packed_topk_int8"].append(_int8_case(card, f"users_int8_q{q}_exclude", users_q,
                                                  users[idx], 10, exclude=idx))
    for q, k in ((1, 10), (64, 10), (16, 600)):
        qs = users[pick(N_USERS, q)]
        out["packed_topk_int8"].append(_int8_case(card, f"anime_int8_q{q}_head_mask_k{k}", anime_q,
                                                  qs, k, mask=anime_mask, head=head))
    tables = {"users": users, "anime": anime}
    for case in K3_CASES:
        table, queries, kw = _case_inputs(rng, tables, case, head, anime_mask)
        out["exact_topk"].append(_exact_case(card, case[0], table, queries, case[4], **kw))
    if max(r["top_r"] for r in out["packed_topk_int8"]) <= 64:
        raise AssertionError("no K2q case drove top_r above 64")
    return out


# ---- phase 3 -------------------------------------------------------------------

@functools.cache
def _dataset():
    """The synthetic ratings at reference scale, preprocessed, with vocab,
    catalog and synopses (made once, from SEED)."""
    from anime_recommendations_tpu_torch.data import synthetic
    from anime_recommendations_tpu_torch.data.preprocess import preprocess_ratings
    from anime_recommendations_tpu_torch.data.vocab import build_vocab

    t0 = time.perf_counter()
    raw = synthetic.synth_ratings(n_users=N_USERS, n_anime=N_ANIME,
                                  n_interactions=N_RATINGS, seed=SEED)
    clean, _ = preprocess_ratings(raw, num_reviews=1)
    vocab = build_vocab(clean)
    catalog = synthetic.synth_anime_catalog(n_anime=N_ANIME, seed=SEED)
    synopses = synthetic.synth_synopses(catalog, seed=SEED)
    print(f"[data] {len(raw)} ratings -> {len(clean)} rows, vocab {vocab.n_users} users "
          f"x {vocab.n_anime} anime, made in {time.perf_counter() - t0:.1f} s", flush=True)
    return clean, vocab, catalog, synopses


@functools.cache
def _train_split():
    """The training and holdout sets PipelineRunner.step_train makes of _dataset()."""
    from anime_recommendations_tpu_torch.config import Config
    from anime_recommendations_tpu_torch.data.dataset import train_holdout_split
    from anime_recommendations_tpu_torch.data.vocab import encode_frame

    clean, vocab, _, _ = _dataset()
    mc = Config().model
    encoded = encode_frame(clean, vocab)[["user", "anime", "rating"]]
    return train_holdout_split(encoded, test_size=min(mc.test_size, max(len(encoded) // 10, 1)),
                               shuffle_seed=mc.vocab_shuffle_seed)


def _write_store(root: Path) -> None:
    """A run directory in the JAX pipeline's artifact-store layout, holding
    what its ingest, preprocess and train steps write."""
    clean, vocab, catalog, synopses = _dataset()
    rng = np.random.default_rng(SEED)
    arrays = {
        "user_emb": rng.uniform(-0.05, 0.05, (vocab.n_users, D)).astype(np.float32),
        "anime_emb": rng.uniform(-0.05, 0.05, (vocab.n_anime, D)).astype(np.float32),
        "dense_w": np.float32(1.7), "dense_b": np.float32(-0.3),
        "bn_gamma": np.float32(0.9), "bn_beta": np.float32(0.2),
        "moving_mean": np.float32(0.1), "moving_var": np.float32(1.4),
    }

    def version_dir(name):
        d = root / name / "v0"
        d.mkdir(parents=True)
        (d / ".metadata.json").write_text(json.dumps({"name": name, "version": 0}))
        return d

    model_dir = version_dir("anime_nn_model.npz")
    np.savez(model_dir / "anime_nn_model.npz", **arrays)
    vocab.save(model_dir / "vocab.json")
    clean.to_parquet(version_dir("preprocessed_stats.parquet") / "preprocessed_stats.parquet",
                     index=False)
    catalog.to_csv(version_dir("all_anime.csv") / "all_anime.csv", index=False)
    synopses.to_csv(version_dir("synopses.csv") / "synopses.csv", index=False)


def _oracle(table, queries, query_idx, k, mask=None, exclude_self=True, head=None):
    """Dense full-score top-k of ``queries[query_idx]`` against ``table`` on
    the context's device, as numpy (values [1, k], vocab rows [1, k])."""
    import torch

    q = torch.as_tensor(np.atleast_1d(query_idx), device=table.device)
    m = None if mask is None else torch.as_tensor(np.asarray(mask), device=table.device)
    v, i = _oracle_topk(table, queries[q], k, m, q if exclude_self else None, head)
    return v.cpu().numpy(), i.cpu().numpy()


def _close(name, got, want, ids_got, ids_want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or got.size == 0:
        raise AssertionError(f"{name}: {got.size} results, oracle {want.size}")
    if not np.all(np.isfinite(got)) or np.abs(got - want).max() > 1e-5:
        raise AssertionError(f"{name}: values differ from the oracle by "
                             f"{np.abs(got - want).max()}")
    if sorted(map(str, ids_got)) != sorted(map(str, ids_want)):
        raise AssertionError(f"{name}: result set differs from the oracle")


def _drive_endpoints(ctx, cfg, label, kernels=K2_COUNTERS) -> dict:
    """Every endpoint through the HTTP server, checked against the oracle;
    each scanning endpoint must launch one of ``kernels`` (launch counter
    names). Returns per-endpoint median latency (ms, host clock around the
    request)."""
    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.recommend.user_recs import user_recs
    from anime_recommendations_tpu_torch.serve.api import make_server

    server = make_server(ctx, cfg, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    latency: dict[str, list[float]] = {}

    def get(endpoint, scans=True, **params):
        url = f"{base}/{endpoint}?{urllib.parse.urlencode(params)}"
        before = sum(_kernels.launches[c] for c in kernels)
        t0 = time.perf_counter()
        with urllib.request.urlopen(url, timeout=120) as resp:
            body = json.loads(resp.read())
        latency.setdefault(endpoint, []).append((time.perf_counter() - t0) * 1e3)
        if scans and sum(_kernels.launches[c] for c in kernels) <= before:
            raise AssertionError(f"{label} /{endpoint}: none of {kernels} was launched")
        if not body:
            raise AssertionError(f"{label} /{endpoint}: empty answer")
        return body

    try:
        rng = np.random.default_rng(SEED + 1)
        vocab, catalog = ctx.vocab, ctx.catalog
        anime, users_t = ctx.anime_norm, ctx.user_norm
        name_of = dict(zip(catalog.anime["anime_id"], catalog.anime["Name"]))
        users = [int(u) for u in rng.choice(vocab.user_ids, size=24, replace=False)]
        names = [str(name_of[int(a)]) for a in rng.choice(vocab.anime_ids, size=8,
                                                           replace=False)]
        if get("health", scans=False)["n_users"] != vocab.n_users:
            raise AssertionError("/health reports the wrong vocab")
        for j, name in enumerate(names[:5]):
            types = ["TV"] if j % 2 else None
            params = dict(name=name, k=10) | ({"types": "TV"} if types else {})
            recs = get("similar_anime", **params)
            qi = ctx.anime_index(catalog.resolve_query(name))
            mask = ctx.in_catalog_mask() & (ctx.type_mask(types) if types else True)
            v, i = _oracle(anime, anime, qi, 10, mask)
            _close(f"{label} similar_anime", [r["Similarity"] for r in recs], v[0],
                   [r["Name"] for r in recs], [name_of[int(a)] for a in vocab.anime_ids[i[0]]])
        for uid in users[0:4]:
            recs = get("similar_users", user_id=uid, k=10)
            v, i = _oracle(users_t, users_t, ctx.user_index(uid), 10)
            _close(f"{label} similar_users", [r["similarity"] for r in recs], v[0],
                   [r["similar_users"] for r in recs], vocab.user_ids[i[0]])
        for uid in users[4:8]:
            prefs = get("user_prefs", scans=False, user_id=uid)
            if prefs["user_id"] != uid or not prefs["favorites"]:
                raise AssertionError(f"{label} /user_prefs: no favorites for {uid}")
        for uid in users[8:12]:
            recs = get("user_recs", user_id=uid, k=10)
            _, i = _oracle(users_t, users_t, ctx.user_index(uid), cfg.users.recs_n_sim_ID)
            want, _ = user_recs(ctx, uid, vocab.user_ids[i[0]], n=10,
                                percentile=cfg.users.favorite_percentile)
            if [r["anime_id"] for r in recs] != want["anime_id"].tolist():
                raise AssertionError(f"{label} /user_recs differs from the oracle")
        for uid in users[12:16]:
            recs = get("model_recs", user_id=uid, k=10)
            mask = ctx.in_catalog_mask() & ~ctx.watched_mask(uid)
            v, i = _oracle(anime, users_t, ctx.user_index(uid), 10, mask,
                           exclude_self=False, head=ctx.head)
            _close(f"{label} model_recs", [r["Prediction"] for r in recs], v[0],
                   [r["anime_id"] for r in recs], vocab.anime_ids[i[0]])
        batch = get("similar_anime_batch", names="|".join(names[5:8]), k=10)
        for rec, name in zip(batch, names[5:8]):
            qi = ctx.anime_index(catalog.resolve_query(name))
            v, i = _oracle(anime, anime, qi, 10, ctx.in_catalog_mask())
            _close(f"{label} similar_anime_batch", rec["similarities"], v[0],
                   rec["anime_ids"], vocab.anime_ids[i[0]])
        batch = get("model_recs_batch", user_ids=",".join(map(str, users[16:20])), k=10)
        for rec, uid in zip(batch, users[16:20]):
            mask = ctx.in_catalog_mask() & ~ctx.watched_mask(uid)
            v, i = _oracle(anime, users_t, ctx.user_index(uid), 10, mask,
                           exclude_self=False, head=ctx.head)
            _close(f"{label} model_recs_batch", rec["predictions"], v[0],
                   rec["anime_ids"], vocab.anime_ids[i[0]])
        batch = get("similar_users_batch", user_ids=",".join(map(str, users[20:24])), k=10)
        for rec, uid in zip(batch, users[20:24]):
            v, i = _oracle(users_t, users_t, ctx.user_index(uid), 10)
            _close(f"{label} similar_users_batch", rec["similarities"], v[0],
                   rec["similar_users"], vocab.user_ids[i[0]])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return {e: statistics.median(t) for e, t in latency.items()}


# label -> (similarity.retrieval_dtype, RecContext topk_kwargs, the scan
# kernels' launch counters)
CONTEXTS = {
    "f32": ("f32", None, K2_COUNTERS),
    "bf16": ("bf16", None, K2_COUNTERS),
    "int8": ("int8", None, ("packed_topk_int8",)),
    "exact_scan": ("f32", {"exact_scan": True}, ("exact_topk",)),
}


def phase_slice(card: str, device: str = "cuda") -> dict:
    import torch

    from anime_recommendations_tpu_torch.config import Config
    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.pipeline.runner import context_from_store, store_root

    latencies = {}
    with tempfile.TemporaryDirectory() as tmp:
        _write_store(store_root(Config(), tmp))
        for label, (dtype, topk_kwargs, kernels) in CONTEXTS.items():
            cfg = Config().with_overrides([f"similarity.retrieval_dtype={dtype}"])
            before = _kernels.launches["l2_normalize"]
            t0 = time.perf_counter()
            ctx = context_from_store(cfg, tmp, device=device, topk_kwargs=topk_kwargs)
            if ctx.device.type == "cuda":
                torch.cuda.synchronize()
            normalized = _kernels.launches["l2_normalize"] - before
            if ctx.device.type == "cuda" and normalized != 2:
                raise AssertionError(f"{label}: the context build launched l2_normalize "
                                     f"{normalized} times, not twice")
            print(f"[phase 3] {label} context built on {ctx.device} in "
                  f"{time.perf_counter() - t0:.1f} s ({normalized} l2_normalize launches)",
                  flush=True)
            latencies[label] = _drive_endpoints(ctx, cfg, label, kernels)
            print(f"[phase 3] {label} endpoint latency ms (median, host clock; {card}): "
                  + json.dumps(latencies[label]), flush=True)
            del ctx
    return latencies


# ---- phase 4 -------------------------------------------------------------------

ADAM_STEP, ADAM_LR, ADAM_L2 = 3, 1e-3, 1e-4
# f32 operations per table element of one fused Adam update: the decay (2),
# the two moments (7), the update (5), the weight (2), the sumsq (2); the
# scatter adds one per gradient element on top.
ADAM_OPS = 18


def _ulp_bf16(x):
    """One bf16 ulp at each value of x (2^-7 of its binade)."""
    import torch

    _, exponent = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exponent - 8)


def _hot_row_tol(c32, bf16_moment: bool):
    """How far a fused-Adam output may lie from its plain version on rows the
    batch hits more than once, where the plain version sums the gradients
    with index_add_'s atomics in another order: 1e-5 of the tensor's largest
    entry (that f32 sum-order error), and for a bf16 moment one bf16 ulp on
    top (two different f32 values may round to neighbouring bf16 values;
    where mu' = b1 mu + (1 - b1) g nearly cancels, the f32 error alone can
    exceed an ulp of the tiny result, so an ulp alone is no sound bound)."""
    tol = 1e-5 * float(c32.abs().max())
    return _ulp_bf16(c32) + tol if bf16_moment else tol


def _beyond_ulp(label: str, diff, c32) -> dict:
    """The bf16 moment's elements more than one ulp from the plain version
    (only the 1e-5-of-scale term of _hot_row_tol admits them) and the
    largest |plain value| among them."""
    beyond = diff > _ulp_bf16(c32)
    largest = float(c32[beyond].abs().max()) if bool(beyond.any()) else 0.0
    return {f"{label}_beyond_one_ulp": int(beyond.sum()),
            f"{label}_beyond_one_ulp_largest_value": largest}


def _adam_tables(rng, n, b, dtype):
    """W, mu, nu [n, D] (moments in dtype) and gradient rows [b, D] from rng."""
    import torch

    dev = torch.device(DEVICE)
    w = torch.from_numpy(rng.uniform(-0.05, 0.05, (n, D)).astype(np.float32)).to(dev)
    mu = torch.from_numpy((rng.standard_normal((n, D)) * 1e-3).astype(np.float32)).to(dev, dtype)
    nu = torch.from_numpy(((rng.standard_normal((n, D)) * 1e-3) ** 2).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy((rng.standard_normal((b, D)) * 1e-3).astype(np.float32)).to(dev)
    return w, mu, nu, g


def _launched(fn) -> tuple:
    """(fn(), the launches of each kernel it made)."""
    from anime_recommendations_tpu_torch.ops import _kernels

    before = dict(_kernels.launches)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in _kernels.launches.items()
                 if v != before.get(k, 0)}


def _tile_order_check(name, got, inputs, ids_s, g_s, scal, sr, dense=None) -> dict:
    """Every row, hot ones too, bit for bit against the plain version fed
    the kernel's own summation order (fused_adam.run_sums_in_tile_order, one
    gradient row per table row): the tiles' edges, partials and order."""
    import torch

    from anime_recommendations_tpu_torch.ops import fused_adam

    n = inputs[0].shape[0]
    sums = fused_adam.run_sums_in_tile_order(ids_s, g_s, n)
    rows = torch.arange(n, dtype=torch.int32, device=sums.device)
    want = fused_adam._sparse_adam_update_plain(*[x.clone() for x in inputs], rows, sums, scal,
                                                ADAM_STEP, sr, dense)
    for label, a, c in zip(("w", "mu", "nu"), got[:3], want[:3]):
        if not torch.equal(a, c):
            raise AssertionError(f"{name}: {label}' differs from the plain version in the "
                                 f"kernel's tile order on {int((a != c).sum())} elements")
    return {"all_rows_bit_equal_in_tile_order": True}


def _tile_pass_case(name, n, ids_s, g_s, nids_s) -> dict:
    """The first pass alone against its plain versions (the tile sums it
    writes and the block starts of the ids and next ids, bit for bit), its
    bytes (the ids and next ids, the gradient rows of the crossing segments,
    the slots and starts written) and the plain versions' device time."""
    import torch

    from anime_recommendations_tpu_torch.ops import fused_adam

    got, starts, gstarts = fused_adam._first_pass_cuda(ids_s, g_s, n, nids_s)
    want, written = fused_adam._tile_sums_plain(ids_s, g_s, n)
    if not (torch.equal(got[written], want[written])
            and torch.equal(starts, fused_adam._block_starts_plain(ids_s, n))
            and torch.equal(gstarts, fused_adam._block_starts_plain(nids_s, n))):
        raise AssertionError(f"{name}: the first pass differs from its plain versions")
    seg, _ = fused_adam._tile_sums_plain(ids_s, torch.ones_like(g_s[:, :4]), n)
    summed = int(seg[written, 0].sum())
    return {"tile_slots_written": int(written.sum()), "tile_rows_summed": summed,
            "tiles_max_abs_err": float((got[written] - want[written]).abs().max())
            if bool(written.any()) else 0.0,
            "tiles_bytes": (ids_s.numel() + nids_s.numel() + 2 * starts.numel()) * 4
            + (summed + int(written.sum())) * D * 4,
            "tiles_plain_ms": _profiled(lambda: (
                fused_adam._tile_sums_plain(ids_s, g_s, n),
                fused_adam._block_starts_plain(ids_s, n),
                fused_adam._block_starts_plain(nids_s, n)))["device_ms"]}


def _copies_pass_case(name, w, nids_s, norder) -> dict:
    """The gather's second pass alone against its plain version (rows
    outside what it writes keep a sentinel in both), its bytes and the
    plain version's device time."""
    import torch

    from anime_recommendations_tpu_torch.ops import fused_adam

    got = torch.full((nids_s.shape[0], D), 7.5, device=w.device)
    want = got.clone()
    fused_adam._copies_cuda(w, nids_s, norder, got)
    fused_adam._copies_plain(w, nids_s, norder, want)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: the gather's second pass differs from the plain version")
    n = w.shape[0]
    first, last, left, right = fused_adam._tile_runs(nids_s)
    tile = torch.arange(nids_s.shape[0], device=w.device) // fused_adam.TILE
    outside = (nids_s < 0) | (nids_s >= n)
    crossing = ~outside & ((left[tile] & (nids_s == first[tile]))
                           | (right[tile] & (nids_s == last[tile])))
    written = int((outside | crossing).sum())
    distinct = int(torch.unique(nids_s[crossing]).numel())
    return {"copies_written": written, "copies_distinct_rows": distinct,
            "copies_max_abs_err": float((got - want).abs().max()),
            "copies_bytes": nids_s.numel() * 8 + (distinct + written) * D * 4,
            "copies_plain_ms": _profiled(lambda: fused_adam._copies_plain(
                w, nids_s, norder, want))["device_ms"]}


def _pass_times(row: dict, prof: dict) -> None:
    """The case's device time: all of its kernels' (ms) and each one's."""
    row["ms"] = prof["match_ms"]
    row["by_kernel_ms"] = prof["match_by_kernel"]
    row["sessions"], row["records_lost"] = prof["sessions"], prof["records_lost"]
    row["prep_device_ms"] = prof["device_ms"] - row["ms"]
    if not row["ms"] > 0:
        raise AssertionError(f"{row['case']}: the profiler saw no kernel time: {prof}")


def _adam_case(card, name, n, ids_np, dtype, seed):
    import torch

    from anime_recommendations_tpu_torch.ops import fused_adam

    rng = np.random.default_rng(seed)
    b = ids_np.shape[0]
    w, mu, nu, g = _adam_tables(rng, n, b, dtype)
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(w.device)
    sr = dtype == torch.bfloat16
    plain_in = [x.clone() for x in (w, mu, nu)]   # the inputs, kept as they were
    plain = [x.clone() for x in plain_in]
    order = torch.argsort(ids, stable=True)
    ids_s, g_s = ids[order], g[order]
    scal = fused_adam.adam_scalars(ADAM_STEP, ADAM_LR, ADAM_L2, 0.9, 0.999, 1e-7)

    got, launches = _launched(lambda: fused_adam.sparse_adam_update(
        w, mu, nu, ids, g, ADAM_STEP, ADAM_LR, l2=ADAM_L2))
    if launches != {"fused_adam_tiles": 1, "fused_adam": 1}:
        raise AssertionError(f"{name}: sparse_adam_update launched {launches}")
    want = fused_adam._sparse_adam_update_plain(*plain, ids_s, g_s, scal, ADAM_STEP, sr)
    torch.cuda.synchronize()
    row = dict(card=card, case=name, n=n, n_mod_block=n % fused_adam.BLOCK_ROWS, batch=b,
               distinct_ids=int(np.unique(ids_np).size),
               largest_run=int(np.bincount(ids_np).max()), moments=str(dtype), sr=sr,
               launches=launches)
    # A row the batch hits at most once has no summation order to differ in:
    # W', mu' and nu' must equal the plain version's bit for bit there, which
    # pins the stochastic rounding's bits (any other rounding or hash lands
    # on the other bf16 neighbour for a share of the elements). Hot rows sum
    # in another order than index_add_'s atomics: the tolerances below; and
    # in the kernel's own order (_tile_order_check) bit for bit.
    once = torch.bincount(ids.long(), minlength=n) <= 1
    row["rows_hit_at_most_once"] = int(once.sum())
    max_abs = 0.0
    for label, a, c in zip(("w", "mu", "nu"), got[:3], want[:3]):
        a32, c32 = a.float(), c.float()
        if not bool(torch.isfinite(a32).all()):
            raise AssertionError(f"{name}: non-finite {label}'")
        diff = (a32 - c32).abs()
        max_abs = max(max_abs, float(diff.max()))
        row[f"{label}_max_abs_err"] = float(diff.max())
        row[f"{label}_err_vs_scale"] = float(diff.max()) / float(c32.abs().max())
        row[f"{label}_bit_equal_share"] = float((a == c).float().mean())
        if not torch.equal(a[once], c[once]):
            raise AssertionError(
                f"{name}: {label}' differs from the plain version on "
                f"{int((a[once] != c[once]).sum())} elements of rows hit at most once")
        if bool((diff > _hot_row_tol(c32, label != "w" and sr)).any()):
            raise AssertionError(f"{name}: {label}' differs from the plain version by "
                                 f"{row[f'{label}_err_vs_scale']} of its scale")
        if label != "w" and sr:
            row |= _beyond_ulp(label, diff, c32)
    row |= _tile_order_check(name, got, plain_in, ids_s, g_s, scal, sr)
    if sr:
        # Stochastic, not to nearest: about a quarter of the stores round the
        # other way than round-to-nearest would.
        nearest = fused_adam._sparse_adam_update_plain(*plain_in, ids_s, g_s, scal, ADAM_STEP,
                                                       False)
        for label, a, c in zip(("mu", "nu"), got[1:3], nearest[1:3]):
            share = float((a != c).float().mean())
            row[f"{label}_share_unlike_nearest"] = share
            if not 0.15 <= share <= 0.35:
                raise AssertionError(f"{name}: {label}' differs from round-to-nearest in "
                                     f"{share} of its elements, not ~0.25")
    row["sumsq_rel_err"] = abs(float(got[3]) - float(want[3])) / float(want[3])
    if not row["sumsq_rel_err"] <= 1e-5:
        raise AssertionError(f"{name}: sumsq differs by {row['sumsq_rel_err']}")
    row["max_abs_err"] = max_abs

    # ms: the device time of the call's kernels (the first pass and the
    # update; torch.profiler); plain_ms: the device time of all of the plain
    # version's kernels. The CUDA-event times are what one call costs its
    # caller on this host, launch overhead included.
    m_bytes = 2 if sr else 4
    moved = 2 * n * D * 4 + 4 * n * D * m_bytes + b * D * 4 + b * 4
    _pass_times(row, _profiled(lambda: fused_adam._sparse_adam_update_cuda(
        w, mu, nu, ids_s, g_s, scal, ADAM_STEP, sr),
        match=("fused_adam_tiles_kernel", "fused_adam_kernel")))
    plain_prof = _profiled(lambda: fused_adam._sparse_adam_update_plain(
        *plain, ids_s, g_s, scal, ADAM_STEP, sr))
    row["plain_ms"], row["plain_sessions"] = plain_prof["device_ms"], plain_prof["sessions"]
    row["plain_records_lost"] = plain_prof["records_lost"]
    row["event_ms"] = _median_ms(lambda: fused_adam._sparse_adam_update_cuda(
        w, mu, nu, ids_s, g_s, scal, ADAM_STEP, sr))
    row["plain_event_ms"] = _median_ms(lambda: fused_adam._sparse_adam_update_plain(
        *plain, ids_s, g_s, scal, ADAM_STEP, sr))
    row["with_sort_event_ms"] = _median_ms(lambda: fused_adam.sparse_adam_update(
        w, mu, nu, ids, g, ADAM_STEP, ADAM_LR, l2=ADAM_L2))
    row["bytes_moved"] = moved
    row["hbm_share"] = moved / (row["ms"] * 1e-3) / HBM_BYTES_PER_S
    row["plain_hbm_share"] = moved / (row["plain_ms"] * 1e-3) / HBM_BYTES_PER_S
    row |= _bound(moved, ADAM_OPS * n * D + b * D)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print("[phase 4] " + json.dumps(row), flush=True)
    return row


def _gather_case(card, name, n, ids_np, next_np, dtype, seed):
    """K5 at the training shapes: against K1 on the same inputs (tables and
    sumsq bit for bit), against W'[next_ids] (exact), and against its plain
    version (K1's plain version, then the plain gather)."""
    import torch

    from anime_recommendations_tpu_torch.ops import fused_adam

    rng = np.random.default_rng(seed)
    b, b2 = ids_np.shape[0], next_np.shape[0]
    w, mu, nu, g = _adam_tables(rng, n, b, dtype)
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(w.device)
    nids = torch.from_numpy(next_np.astype(np.int32)).to(w.device)
    sr = dtype == torch.bfloat16
    k1 = [x.clone() for x in (w, mu, nu)]
    plain = [x.clone() for x in (w, mu, nu)]
    order = torch.argsort(ids, stable=True)
    ids_s, g_s = ids[order], g[order]
    norder = torch.argsort(nids, stable=True)
    gather = (nids[norder], norder.to(torch.int32))
    scal = fused_adam.adam_scalars(ADAM_STEP, ADAM_LR, ADAM_L2, 0.9, 0.999, 1e-7)

    got, launches = _launched(lambda: fused_adam.sparse_adam_update(
        w, mu, nu, ids, g, ADAM_STEP, ADAM_LR, l2=ADAM_L2, next_ids=nids))
    if launches != {"fused_adam_tiles": 1, "fused_adam_gather": 1, "fused_adam_copies": 1}:
        raise AssertionError(f"{name}: sparse_adam_update(next_ids=...) launched {launches}")
    ref = fused_adam.sparse_adam_update(*k1, ids, g, ADAM_STEP, ADAM_LR, l2=ADAM_L2)
    want = fused_adam._sparse_adam_update_plain(*plain, ids_s, g_s, scal, ADAM_STEP, sr)
    want_rows = fused_adam._gather_rows_plain(want[0], nids)
    torch.cuda.synchronize()
    for label, a, c in zip(("w", "mu", "nu", "sumsq"), got[:4], ref):
        if not torch.equal(a, c):
            raise AssertionError(f"{name}: {label}' is not bit-equal to K1's on the same inputs")
    inside = (nids >= 0) & (nids < n)
    rows = got[4]
    if rows.shape != (b2, D) or not torch.equal(rows[inside], w[nids[inside].long()]):
        raise AssertionError(f"{name}: the gathered rows are not W'[next_ids]")
    if bool(rows[~inside].any()):
        raise AssertionError(f"{name}: a next id outside the table got a nonzero row")
    if rows.untyped_storage().data_ptr() == w.untyped_storage().data_ptr():
        raise AssertionError(f"{name}: the gathered rows alias the table")
    row = dict(card=card, case=name, n=n, batch=b, next_ids=b2,
               distinct_next_ids=int(np.unique(next_np).size),
               largest_next_run=int(np.bincount(next_np[(next_np >= 0) & (next_np < n)]).max()),
               next_ids_outside=int((~inside).sum()), moments=str(dtype), sr=sr,
               launches=launches, tables_bit_equal_to_k1=True, rows_equal_w_next=True)
    # Against the plain version: the tolerances of _adam_case's hot rows.
    max_abs = 0.0
    for label, a, c in zip(("w", "mu", "nu", "rows"), got[:3] + (rows,), want[:3] + (want_rows,)):
        a32, c32 = a.float(), c.float()
        diff = (a32 - c32).abs()
        max_abs = max(max_abs, float(diff.max()))
        row[f"{label}_max_abs_err"] = float(diff.max())
        if bool((diff > _hot_row_tol(c32, label in ("mu", "nu") and sr)).any()):
            raise AssertionError(f"{name}: {label} differs from the plain version by "
                                 f"{float(diff.max())}")
        if label in ("mu", "nu") and sr:
            row |= _beyond_ulp(label, diff, c32)
    row["max_abs_err"] = max_abs
    row |= _tile_pass_case(name, n, ids_s, g_s, gather[0])
    row |= _copies_pass_case(name, w, *gather)

    m_bytes = 2 if sr else 4
    moved = (2 * n * D * 4 + 4 * n * D * m_bytes + b * D * 4 + b * 4
             + b2 * 4 * 2 + b2 * D * 4)   # + sorted next ids, their order, the rows
    kernels = ("fused_adam_tiles_kernel", "fused_adam_gather_kernel", "fused_adam_copies_kernel")
    run = lambda: fused_adam._sparse_adam_update_cuda(w, mu, nu, ids_s, g_s, scal, ADAM_STEP,
                                                      sr, gather)
    _pass_times(row, _profiled(run, match=kernels))
    plain_prof = _profiled(lambda: (fused_adam._sparse_adam_update_plain(
        *plain, ids_s, g_s, scal, ADAM_STEP, sr), fused_adam._gather_rows_plain(plain[0], nids)))
    row["plain_ms"], row["plain_sessions"] = plain_prof["device_ms"], plain_prof["sessions"]
    row["plain_records_lost"] = plain_prof["records_lost"]
    row["event_ms"] = _median_ms(run)
    # K1 alone on the same inputs, in the same call: what the gather adds.
    row["k1_ms"] = _profiled(lambda: fused_adam._sparse_adam_update_cuda(
        *k1, ids_s, g_s, scal, ADAM_STEP, sr),
        match=("fused_adam_tiles_kernel", "fused_adam_kernel"))["match_ms"]
    row["with_sort_event_ms"] = _median_ms(lambda: fused_adam.sparse_adam_update(
        w, mu, nu, ids, g, ADAM_STEP, ADAM_LR, l2=ADAM_L2, next_ids=nids))
    row["bytes_moved"] = moved
    row["hbm_share"] = moved / (row["ms"] * 1e-3) / HBM_BYTES_PER_S
    row |= _bound(moved, ADAM_OPS * n * D + b * D)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print("[phase 4] " + json.dumps(row), flush=True)
    return row


ZIPF_SEED, ZIPF_RATINGS, ZIPF_LATENT = 5, 2_000_000, 16


@functools.cache
def _zipf_ratings():
    """bench.py:570-692's trained-table data, drawn in its order from
    np.random.default_rng(5): latent factors [91,641 | 17,560, 16], then
    2,000,000 ratings of user min(pareto(1.1) * 40, 91,640) and anime
    min(pareto(1.05) * 15, 17,559) (popular rows at low ids), rated
    sigmoid(3 <u, a> + N(0, 0.35))."""
    rng = np.random.default_rng(ZIPF_SEED)
    u_lat = rng.normal(size=(N_USERS, ZIPF_LATENT)).astype(np.float32) / np.sqrt(ZIPF_LATENT)
    a_lat = rng.normal(size=(N_ANIME, ZIPF_LATENT)).astype(np.float32) / np.sqrt(ZIPF_LATENT)
    users = np.minimum((rng.pareto(1.1, ZIPF_RATINGS) * 40).astype(np.int64), N_USERS - 1)
    anime = np.minimum((rng.pareto(1.05, ZIPF_RATINGS) * 15).astype(np.int64), N_ANIME - 1)
    aff = np.einsum("ij,ij->i", u_lat[users], a_lat[anime])
    ratings = 1.0 / (1.0 + np.exp(-(3.0 * aff + rng.normal(0, 0.35, ZIPF_RATINGS))))
    return users.astype(np.int32), anime.astype(np.int32), ratings.astype(np.float32)


def _adam_cases():
    """(name, table rows, batch ids, moment dtype) of phase 4: the synthetic
    training data's first batch, every id on its hottest user, and
    (``_skewed``) the first 10,000 of _zipf_ratings' ids."""
    import torch

    train, _ = _train_split()
    users, anime = train.users[:BATCH], train.anime[:BATCH]
    hot_user = np.bincount(users).argmax()
    zu, za, _ = _zipf_ratings()
    return (
        ("users_f32", N_USERS, users, torch.float32),
        ("anime_f32", N_ANIME, anime, torch.float32),
        ("users_bf16_sr", N_USERS, users, torch.bfloat16),
        ("anime_bf16_sr", N_ANIME, anime, torch.bfloat16),
        ("users_f32_one_id", N_USERS, np.full(BATCH, hot_user), torch.float32),
        ("users_bf16_sr_one_id", N_USERS, np.full(BATCH, hot_user), torch.bfloat16),
        ("users_f32_skewed", N_USERS, zu[:BATCH], torch.float32),
        ("anime_f32_skewed", N_ANIME, za[:BATCH], torch.float32),
        ("users_bf16_sr_skewed", N_USERS, zu[:BATCH], torch.bfloat16),
        ("anime_bf16_sr_skewed", N_ANIME, za[:BATCH], torch.bfloat16),
    )


def _next_ids(name: str, n: int) -> np.ndarray:
    """The next batch's ids of a phase-4 case: the training data's next
    10,000 ids of its table (skewed: duplicates among them; all on one row
    for a one-id case; _zipf_ratings' next 10,000 for a skewed case), 8 of
    them replaced by ids outside [0, n)."""
    train, _ = _train_split()
    zu, za, _ = _zipf_ratings()
    if name.endswith("skewed"):
        ids = (zu if name.startswith("users") else za)[BATCH:2 * BATCH].copy()
    else:
        ids = (train.users if name.startswith("users") else train.anime)[BATCH:2 * BATCH].copy()
    if "one_id" in name:
        ids[:] = np.bincount(ids).argmax()
    ids[np.arange(8) * (BATCH // 8) + 5] = [-1, n, n + 17, -(2 ** 20), 2 ** 30, -5, n + 31, n]
    return ids


def phase_adam(card: str) -> tuple[list[dict], list[dict]]:
    """K1's cases, then K5's on the same tables and batches."""
    cases = _adam_cases()
    rows = [_adam_case(card, name, n, ids, dtype, SEED + i)
            for i, (name, n, ids, dtype) in enumerate(cases)]
    gather_rows = [_gather_case(card, name, n, ids, _next_ids(name, n), dtype, SEED + 20 + i)
                   for i, (name, n, ids, dtype) in enumerate(cases)]
    return rows, gather_rows


# ---- phase 5 -------------------------------------------------------------------

OPTIMIZERS = ("adam", "lazy_adam", "fused_adam", "fused_adam_bf16m")
FUSED = ("fused_adam", "fused_adam_bf16m")


def _fresh_state(optimizer: str):
    """The optimizer's initial state at full width, from SEED, on the card."""
    import torch

    from anime_recommendations_tpu_torch.train import trainer as tr

    _, vocab, _, _ = _dataset()
    state = tr.init_train_state(vocab.n_users, vocab.n_anime, D,
                                generator=torch.Generator().manual_seed(SEED), device=DEVICE)
    if optimizer == "fused_adam_bf16m":
        state = tr.cast_table_moments(state, torch.bfloat16)
    return state


def _host_timed(fn):
    """(fn(), seconds) on the host clock between two synchronizes."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _step_profile(window_fn, steps: int, ms_per_step: float) -> dict:
    """``window_fn`` runs ``steps`` training steps: their device time under
    torch.profiler, per step. The profiler slows the host, so the idle share
    under it overstates the timed epoch's: both are given, the second
    against the unprofiled ms/step."""
    prof = _profiled(window_fn, reps=1)
    per_step = {"wall_ms": prof["wall_ms"] / steps, "device_ms": prof["device_ms"] / steps,
                "by_kernel": {k: v / steps for k, v in prof["by_kernel"].items()}}
    return dict(profiled_step=per_step, idle_share_profiled=prof["idle_share"],
                idle_share_timed=1 - per_step["device_ms"] / ms_per_step)


def _timed_epoch(optimizer: str) -> dict:
    """One more epoch of the device loop from a fresh state, timed with the
    host clock between two synchronizes; then 10 steps (the first 10
    batches, unshuffled) under torch.profiler."""
    import torch

    from anime_recommendations_tpu_torch.train import device_loop as dl

    train, _ = _train_split()
    state = _fresh_state(optimizer)
    data = dl.stage(train, BATCH, seed=SEED, device=DEVICE)
    steps = data.n // BATCH
    (_, losses, _, _), seconds = _host_timed(lambda: dl.train_epoch(
        state, data, torch.Generator().manual_seed(SEED), 1e-5, BATCH, 1e-4,
        optimizer=optimizer))
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{optimizer}: non-finite loss in the timed epoch")
    window = dl.DeviceData(*(x[:10 * BATCH] for x in data))
    ms_per_step = seconds * 1e3 / steps
    return dict(steps=steps, ms_per_step=ms_per_step, examples_per_sec=len(train) / seconds,
                **_step_profile(lambda: dl.train_epoch(state, window, None, 1e-5, BATCH, 1e-4,
                                                       shuffle=False, optimizer=optimizer),
                                10, ms_per_step))


def _history_gap(hist, ref) -> dict:
    """Largest relative gap per history column."""
    return {c: float(np.max(np.abs(hist[c].to_numpy() - ref[c].to_numpy())
                            / np.abs(ref[c].to_numpy())))
            for c in ("loss", "mse", "val_loss", "val_mse")}


# Fused vs dense history over 2 epochs (594 steps): the largest relative gap
# per column that the check accepts. The first run on an H100 gave at most
# 9.1e-7 for fused_adam (the two paths differ only in summation order) and
# 1.7e-5 for fused_adam_bf16m (bf16 moments, stochastically rounded).
FUSED_TOL = dict.fromkeys(("loss", "mse", "val_loss", "val_mse"), 1e-5)
BF16M_TOL = dict.fromkeys(("loss", "mse", "val_loss", "val_mse"), 1e-4)


def phase_train(card: str) -> dict:
    import torch

    from anime_recommendations_tpu_torch.config import Config
    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.pipeline.runner import PipelineRunner, store_root

    train, _ = _train_split()
    steps_per_epoch = -(-len(train) // min(Config().model.batch_size, len(train)))
    out = {"launches": {}, "history": {}, "train_seconds": {}}
    with tempfile.TemporaryDirectory() as tmp:
        _write_store(store_root(Config(), tmp))
        for optimizer in OPTIMIZERS:
            cfg = Config().with_overrides([
                f"model.optimizer={optimizer}", f"model.epochs={TRAIN_EPOCHS}",
                "model.export_weight_csvs=false", "model.device_loop=true"])
            runner = PipelineRunner(cfg, tmp, device=DEVICE)
            before = dict(_kernels.launches)
            t0 = time.perf_counter()
            result = runner.step_train()
            torch.cuda.synchronize()
            out["train_seconds"][optimizer] = time.perf_counter() - t0
            launched = {k: _kernels.launches[k] - before.get(k, 0)
                        for k in ("fused_adam_tiles", "fused_adam", "fused_adam_gather")}
            steps = steps_per_epoch * result.epochs_run
            # The fused epochs run the pipelined loop with the gather after
            # the update (train_epoch's kernel_gather=False, as in JAX): K1
            # (its first pass and the update) twice a step, K5 never.
            want = 2 * steps if optimizer in FUSED else 0
            if launched != {"fused_adam_tiles": want, "fused_adam": want, "fused_adam_gather": 0}:
                raise AssertionError(f"{optimizer}: launches {launched} for {steps} steps, "
                                     f"expected {want} of K1 and its first pass, and no K5")
            out["launches"][optimizer] = launched["fused_adam"]
            out.setdefault("tile_launches", {})[optimizer] = launched["fused_adam_tiles"]
            hist = result.history
            if len(hist) != TRAIN_EPOCHS or not np.isfinite(hist.to_numpy()).all():
                raise AssertionError(f"{optimizer}: history {hist.to_dict('list')}")
            if optimizer == "lazy_adam" and not hist["loss"].iloc[1] < hist["loss"].iloc[0]:
                raise AssertionError(f"lazy_adam: training loss did not fall: {hist['loss'].tolist()}")
            if optimizer == "fused_adam_bf16m":
                moments = result.state.adam
                if {moments.mu[k].dtype for k in ("user_emb", "anime_emb")} | {
                        moments.nu[k].dtype for k in ("user_emb", "anime_emb")} != {torch.bfloat16}:
                    raise AssertionError("fused_adam_bf16m: table moments are not bf16")
            out["history"][optimizer] = hist
            print(f"[phase 5] {optimizer}: {json.dumps(launched)} over {steps} steps, "
                  f"trained in {out['train_seconds'][optimizer]:.1f} s, "
                  f"{result.examples_per_sec:.0f} examples/s through fit (eval and "
                  f"checkpoints included); history {json.dumps(hist.to_dict('list'))}",
                  flush=True)
        ref = out["history"]["adam"]
        for optimizer, tol in (("fused_adam", FUSED_TOL), ("fused_adam_bf16m", BF16M_TOL)):
            gap = _history_gap(out["history"][optimizer], ref)
            print(f"[phase 5] {optimizer} vs adam, largest relative gap per column: "
                  f"{json.dumps(gap)}; accepted: {json.dumps(tol)}", flush=True)
            if any(gap[c] > tol[c] for c in tol):
                raise AssertionError(f"{optimizer}: history does not track adam's")
        # The trained store serves: the latest model is fused_adam_bf16m's.
        ctx = runner.context()
        torch.cuda.synchronize()
        before = _k2_launches()
        out["serving_ms"] = _drive_endpoints(ctx, cfg, "trained")
        out["serving_launches"] = _k2_launches() - before
        print(f"[phase 5] trained store served every endpoint in agreement with the dense "
              f"oracle (overlap 1.0); latency ms ({card}): {json.dumps(out['serving_ms'])}",
              flush=True)
    out["timed"] = {}
    for optimizer in OPTIMIZERS:
        out["timed"][optimizer] = _timed_epoch(optimizer)
        print(f"[phase 5] {optimizer} timed epoch ({card}): "
              f"{json.dumps(out['timed'][optimizer])}", flush=True)
    return out


# ---- phase 6 -------------------------------------------------------------------

def phase_gather(card: str) -> dict:
    """One pipelined fused epoch with K5's gather and one without, from the
    same state and shuffle, per fused optimizer. Returns each run's
    launches, ms/step and device profile."""
    import torch

    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.train import device_loop as dl
    from anime_recommendations_tpu_torch.train import trainer as tr

    train, _ = _train_split()
    data = dl.granule_shuffle(dl.stage(train, BATCH, seed=SEED, device=DEVICE),
                              torch.Generator().manual_seed(SEED))
    steps = data.n // BATCH
    window = dl.DeviceData(*(x[:10 * BATCH] for x in data))
    out = {}
    for optimizer in FUSED:
        runs = {}
        for kernel_gather in (True, False):
            state = _fresh_state(optimizer)
            _kernels.launches.clear()
            (state, losses, mses), seconds = _host_timed(lambda: dl._fused_epoch(
                state, data, 1e-5, BATCH, 1e-4, kernel_gather=kernel_gather))
            launches = {k: _kernels.launches[k] for k in
                        ("fused_adam_tiles", "fused_adam", "fused_adam_gather",
                         "fused_adam_copies")}
            want = {"fused_adam_tiles": 2 * steps, "fused_adam": 0,
                    "fused_adam_gather": 2 * steps, "fused_adam_copies": 2 * steps}
            if not kernel_gather:
                want = {"fused_adam_tiles": 2 * steps, "fused_adam": 2 * steps,
                        "fused_adam_gather": 0, "fused_adam_copies": 0}
            if launches != want:
                raise AssertionError(f"{optimizer} kernel_gather={kernel_gather}: launches "
                                     f"{launches}, expected {want}")
            if not bool(torch.isfinite(losses).all()):
                raise AssertionError(f"{optimizer} kernel_gather={kernel_gather}: non-finite loss")
            ms_per_step = seconds * 1e3 / steps
            runs[kernel_gather] = dict(
                launches=launches, losses=losses, mses=mses, state=tr.train_state_to_numpy(state),
                timing=dict(steps=steps, ms_per_step=ms_per_step, **_step_profile(
                    lambda: dl._fused_epoch(state, window, 1e-5, BATCH, 1e-4,
                                            kernel_gather=kernel_gather), 10, ms_per_step)))
        a, b = runs[True], runs[False]
        if not (torch.equal(a["losses"], b["losses"]) and torch.equal(a["mses"], b["mses"])):
            gap = float((a["losses"] - b["losses"]).abs().max())
            raise AssertionError(f"{optimizer}: kernel_gather changes the losses (by {gap})")
        differ = [k for k in a["state"] if not np.array_equal(a["state"][k], b["state"][k])]
        if differ:
            raise AssertionError(f"{optimizer}: kernel_gather changes the state: {differ}")
        out[optimizer] = {kg: dict(launches=r["launches"], **r["timing"])
                          for kg, r in (("kernel_gather", a), ("gather_after", b))}
        # Whether the gather inside the kernel now costs the epoch nothing:
        # per step, on the host clock and on the device (profiled steps).
        ta, tb = a["timing"], b["timing"]
        out[optimizer]["kernel_gather_minus_after"] = {
            "ms_per_step": ta["ms_per_step"] - tb["ms_per_step"],
            "device_ms_per_step": (ta["profiled_step"]["device_ms"]
                                   - tb["profiled_step"]["device_ms"])}
        print(f"[phase 6] {optimizer}: an epoch of {steps} steps with K5's gather equals the "
              f"epoch without it bit for bit (losses, mses, tables, moments); ({card}) "
              f"{json.dumps(out[optimizer])}", flush=True)
    return out


# tests/test_convergence.py's thresholds at CI_SCALE.
def _check_converged(optimizer: str, r, spec) -> None:
    first = float(r.history["val_mse"].iloc[0])
    checks = {
        "history columns": list(r.history.columns) == ["loss", "mse", "val_loss", "val_mse", "lr"],
        "trained shapes": (r.n_users_trained, r.n_anime_trained) == (spec.n_users, spec.n_anime),
        "best < 0.6 x first val_mse": r.best_val_mse < 0.6 * first,
        "floor > 0": r.noise_floor_mse > 0.0,
        "floor ratio < 2.6": r.floor_ratio < 2.6,
        "top-k overlap >= 0.40": r.topk_overlap >= 0.40,
        "ceiling > overlap": r.arch_ceiling_overlap > r.topk_overlap,
        "expressible overlap >= 0.40": r.expressible_overlap >= 0.40,
        "recall >= 0.85": r.topk_recall >= 0.85,
        "recall ceiling >= recall - 0.05": r.recall_ceiling >= r.topk_recall - 0.05,
        "best epoch in range": 0 <= r.best_epoch < spec.epochs,
        "best val_mse is the history's": bool(np.isclose(
            float(r.history["val_mse"].iloc[r.best_epoch]), r.best_val_mse)),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{optimizer}: CI-scale convergence failed {failed}")


def phase_convergence(card: str) -> dict:
    """train/convergence.py at CI_SCALE on the card, every optimizer."""
    import dataclasses

    from anime_recommendations_tpu_torch.train.convergence import CI_SCALE, run_convergence

    out = {}
    for optimizer in OPTIMIZERS:
        spec = dataclasses.replace(CI_SCALE, optimizer=optimizer)
        report, seconds = _host_timed(lambda: run_convergence(spec, verbose=False, device=DEVICE))
        summary = report.summary()
        summary.pop("spec")
        summary["first_val_mse"] = float(report.history["val_mse"].iloc[0])
        summary["epochs_run"] = len(report.history)
        summary["seconds"] = seconds
        if not np.isfinite(np.asarray(list(summary.values()), np.float64)).all():
            raise AssertionError(f"{optimizer}: non-finite convergence metrics {summary}")
        if optimizer == "lazy_adam":
            if not report.best_val_mse < summary["first_val_mse"]:
                raise AssertionError(f"lazy_adam: best val_mse {report.best_val_mse} not below "
                                     f"the first epoch's {summary['first_val_mse']}")
        else:
            _check_converged(optimizer, report, spec)
        out[optimizer] = summary
        print(f"[phase 6] convergence at CI scale on the card, {optimizer} ({card}): "
              f"{json.dumps(summary)}", flush=True)
    return out


# ---- phase 7 -------------------------------------------------------------------

CAPPED = 512   # slots per (sender, owner): every batch takes > 4 rounds on both tables
AGREE_STEPS = 20


def init_nccl() -> None:
    """The default process group: NCCL, world size 1, on a free local port."""
    import socket

    import torch
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError("the process group is not NCCL at world size 1")


def _dense_case(card, name, n, ids_np, dtype, seed):
    """K1 with a seeded dense gradient: against its plain version, and a
    precomputed stable order against the call without it."""
    import torch

    from anime_recommendations_tpu_torch.ops import fused_adam

    rng = np.random.default_rng(seed)
    b = ids_np.shape[0]
    w, mu, nu, g = _adam_tables(rng, n, b, dtype)
    dense = torch.from_numpy((rng.standard_normal((n, D)) * 1e-4).astype(np.float32)).to(w.device)
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(w.device)
    sr = dtype == torch.bfloat16
    order = torch.argsort(ids, stable=True)
    ids_s, g_s = ids[order], g[order]
    k1 = [x.clone() for x in (w, mu, nu)]
    no_order = [x.clone() for x in (w, mu, nu)]
    plain = [x.clone() for x in (w, mu, nu)]
    inputs = [x.clone() for x in (w, mu, nu)]
    scal = fused_adam.adam_scalars(ADAM_STEP, ADAM_LR, ADAM_L2, 0.9, 0.999, 1e-7)
    (got, alone), launches = _launched(lambda: (
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, ADAM_STEP, ADAM_LR, l2=ADAM_L2,
                                      dense_grad=dense, order=order),
        fused_adam.sparse_adam_update(*no_order, ids, g, ADAM_STEP, ADAM_LR, l2=ADAM_L2,
                                      dense_grad=dense)))
    if launches != {"fused_adam_tiles": 2, "fused_adam_dense": 2}:
        raise AssertionError(f"{name}: two calls of sparse_adam_update(dense_grad=...) "
                             f"launched {launches}")
    want = fused_adam._sparse_adam_update_plain(*plain, ids_s, g_s, scal, ADAM_STEP, sr, dense)
    torch.cuda.synchronize()
    for label, a, c in zip(("w", "mu", "nu", "sumsq"), got, alone):
        if not torch.equal(a, c):
            raise AssertionError(f"{name}: {label}' with order= differs from without it")
    row = dict(card=card, case=name, n=n, n_mod_block=n % fused_adam.BLOCK_ROWS, batch=b,
               distinct_ids=int(np.unique(ids_np).size),
               largest_run=int(np.bincount(ids_np).max()), moments=str(dtype), sr=sr,
               launches={k: v // 2 for k, v in launches.items()}, order_bit_equal=True)
    row |= _against_plain(name, got, want, ids, n, sr)
    row |= _tile_order_check(name, got, inputs, ids_s, g_s, scal, sr, dense)
    m_bytes = 2 if sr else 4
    moved = 3 * n * D * 4 + 4 * n * D * m_bytes + b * D * 4 + b * 4   # + the dense read
    row |= _timing(lambda: fused_adam._sparse_adam_update_cuda(
                       w, mu, nu, ids_s, g_s, scal, ADAM_STEP, sr, dense=dense),
                   lambda: fused_adam._sparse_adam_update_plain(
                       *plain, ids_s, g_s, scal, ADAM_STEP, sr, dense),
                   ("fused_adam_tiles_kernel", "fused_adam_dense_kernel"))
    # K1 without the dense gradient on the same inputs, in the same call.
    row["k1_ms"] = _profiled(lambda: fused_adam._sparse_adam_update_cuda(
        *k1, ids_s, g_s, scal, ADAM_STEP, sr),
        match=("fused_adam_tiles_kernel", "fused_adam_kernel"))["match_ms"]
    row["bytes_moved"] = moved
    row["hbm_share"] = moved / (row["ms"] * 1e-3) / HBM_BYTES_PER_S
    row |= _bound(moved, (ADAM_OPS + 1) * n * D + b * D)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print("[phase 7] " + json.dumps(row), flush=True)
    return row


def _against_plain(name, got, want, ids, n, sr) -> dict:
    """Rows hit at most once bit for bit; hot rows within _hot_row_tol;
    sumsq within 1e-5. Returns the errors."""
    import torch

    once = torch.bincount(ids.long().clamp(0, n), minlength=n + 1)[:n] <= 1
    row = {"rows_hit_at_most_once": int(once.sum())}
    max_abs = 0.0
    for label, a, c in zip(("w", "mu", "nu"), got[:3], want[:3]):
        a32, c32 = a.float(), c.float()
        if not bool(torch.isfinite(a32).all()):
            raise AssertionError(f"{name}: non-finite {label}'")
        diff = (a32 - c32).abs()
        max_abs = max(max_abs, float(diff.max()))
        row[f"{label}_max_abs_err"] = float(diff.max())
        if not torch.equal(a[once], c[once]):
            raise AssertionError(f"{name}: {label}' differs from the plain version on rows "
                                 "hit at most once")
        if bool((diff > _hot_row_tol(c32, label != "w" and sr)).any()):
            raise AssertionError(f"{name}: {label}' differs from the plain version by "
                                 f"{float(diff.max())}")
    row["sumsq_rel_err"] = abs(float(got[3]) - float(want[3])) / float(want[3])
    if not row["sumsq_rel_err"] <= 1e-5:
        raise AssertionError(f"{name}: sumsq differs by {row['sumsq_rel_err']}")
    row["max_abs_err"] = max_abs
    return row


def _receipts_case(card, name, n, ids_np, dtype, seed):
    """K1 on the routed trainer's own receipts at CAPPED slots: staged
    receipts and the dense overflow from route_grad_rows, with and without
    receipt_sort_order's order, and against the plain version."""
    import torch

    from anime_recommendations_tpu_torch.ops import _kernels, fused_adam
    from anime_recommendations_tpu_torch.parallel import routing as rt

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    b = ids_np.shape[0]
    w = torch.from_numpy(rng.uniform(-0.05, 0.05, (n, D)).astype(np.float32)).to(dev)
    mu = torch.from_numpy((rng.standard_normal((n, D)) * 1e-3).astype(np.float32)).to(dev, dtype)
    nu = torch.from_numpy(((rng.standard_normal((n, D)) * 1e-3) ** 2).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy((rng.standard_normal((b, D)) * 1e-3).astype(np.float32)).to(dev)
    ids = torch.from_numpy(ids_np.astype(np.int64)).to(dev)
    plan = rt.make_plan(ids, 1, CAPPED)
    oid, og, dense = rt.route_grad_rows(ids, g, n_shards=1, capacity=CAPPED, r_local=n,
                                        plan=plan)
    order = rt.receipt_sort_order(ids, n_shards=1, capacity=CAPPED, r_local=n, plan=plan)
    if dense is None or plan.rounds <= 4:
        raise AssertionError(f"{name}: {plan.rounds} rounds at capacity {CAPPED}: no overflow")
    sr = dtype == torch.bfloat16
    no_order = [x.clone() for x in (w, mu, nu)]
    plain = [x.clone() for x in (w, mu, nu)]
    before = _kernels.launches["fused_adam_dense"]
    got = fused_adam.sparse_adam_update(w, mu, nu, oid, og, ADAM_STEP, ADAM_LR, l2=ADAM_L2,
                                        dense_grad=dense, order=order)
    alone = fused_adam.sparse_adam_update(*no_order, oid, og, ADAM_STEP, ADAM_LR, l2=ADAM_L2,
                                          dense_grad=dense)
    if _kernels.launches["fused_adam_dense"] != before + 2:
        raise AssertionError(f"{name}: the receipts did not go through the dense kernel")
    scal = fused_adam.adam_scalars(ADAM_STEP, ADAM_LR, ADAM_L2, 0.9, 0.999, 1e-7)
    want = fused_adam._sparse_adam_update_plain(*plain, oid[order].int(), og[order], scal,
                                                ADAM_STEP, sr, dense)
    torch.cuda.synchronize()
    for label, a, c in zip(("w", "mu", "nu", "sumsq"), got, alone):
        if not torch.equal(a, c):
            raise AssertionError(f"{name}: {label}' with the receipt order differs from without")
    row = dict(card=card, case=name, n=n, batch=b, capacity=CAPPED, rounds=plan.rounds,
               receipts=int(oid.shape[0]), moments=str(dtype), sr=sr, order_bit_equal=True)
    row |= _against_plain(name, got, want, oid.clamp(max=n), n, sr)
    print("[phase 7] " + json.dumps(row), flush=True)
    return row


def phase_dense(card: str, receipts: bool) -> list[dict]:
    """7a: K1's dense branch on phase 4's tables and training batches: the
    seeded dense gradients (timed: right after phase 4, before phase 6's runs
    and the process group, after which profiler sessions lose records; the
    skewed anime batch too), or
    (``receipts``, on the group) the routed trainer's receipts (the skewed
    batch has too few distinct ids to take more than 4 rounds)."""
    case = _receipts_case if receipts else _dense_case
    tag = "receipts" if receipts else "dense"
    cases = [c for c in _adam_cases() if c[0] in (
        "users_f32", "anime_f32", "users_bf16_sr", "anime_bf16_sr",
        *(() if receipts else ("anime_f32_skewed", "anime_bf16_sr_skewed")))]
    return [case(card, f"{name}_{tag}", n, ids, dtype, SEED + (50 if receipts else 40) + i)
            for i, (name, n, ids, dtype) in enumerate(cases)]


def _routed_trainer(optimizer: str, capacity=None):
    from anime_recommendations_tpu_torch.parallel.trainer import ShardedTrainer

    return ShardedTrainer(batch_size=BATCH, optimizer=optimizer, capacity=capacity, seed=SEED,
                          verbose=False, device=DEVICE, device_loop=True)


def _rounds(capacity: int) -> dict:
    """(least, most) exchange rounds per table over the epoch's batches."""
    from anime_recommendations_tpu_torch.parallel import routing as rt

    train, _ = _train_split()
    order = np.random.default_rng(SEED).permutation(len(train))
    out = {}
    for name, ids in (("users", train.users[order]), ("anime", train.anime[order])):
        rounds = [rt.plan_stats(ids[i:i + BATCH], 1, capacity)[2]
                  for i in range(0, len(ids) - BATCH + 1, BATCH)]
        out[name] = (min(rounds), max(rounds))
    return out


def _timed_routed_epoch(optimizer: str, capacity=None) -> dict:
    """One routed epoch (plans included) from a fresh state, host clock
    between synchronizes; then 10 steps under torch.profiler."""
    import torch

    from anime_recommendations_tpu_torch.train import device_loop as dl

    train, _ = _train_split()
    _, vocab, _, _ = _dataset()
    trainer = _routed_trainer(optimizer, capacity)
    state = trainer._init_state(torch.Generator().manual_seed(SEED), vocab.n_users, vocab.n_anime)
    data = dl.granule_shuffle(dl.stage(train, BATCH, seed=SEED, device=DEVICE),
                              torch.Generator().manual_seed(SEED))
    steps = data.n // BATCH
    (_, losses, _, _), seconds = _host_timed(lambda: trainer.train_epoch(state, data, BATCH, 1e-5))
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"routed {optimizer}: non-finite loss in the timed epoch")
    window = dl.DeviceData(*(x[:10 * BATCH] for x in data))
    ms_per_step = seconds * 1e3 / steps
    return dict(steps=steps, ms_per_step=ms_per_step, examples_per_sec=len(train) / seconds,
                **_step_profile(lambda: trainer.train_epoch(state, window, BATCH, 1e-5), 10,
                                ms_per_step))


def _agree_steps() -> dict:
    """AGREE_STEPS steps, each from one state at the default capacity and at
    CAPPED slots: losses and tables must agree."""
    import copy

    import torch

    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.train import device_loop as dl

    train, _ = _train_split()
    _, vocab, _, _ = _dataset()
    default, capped = _routed_trainer("fused_adam"), _routed_trainer("fused_adam", CAPPED)
    state = default._init_state(torch.Generator().manual_seed(SEED), vocab.n_users, vocab.n_anime)
    data = dl.stage(train, BATCH, seed=SEED, device=DEVICE)
    cols = [x[:AGREE_STEPS * BATCH].view(AGREE_STEPS, BATCH) for x in data]
    _kernels.launches.clear()
    worst = {"loss": 0.0, "tables": 0.0}
    for i in range(AGREE_STEPS):
        other = copy.deepcopy(state)
        state, loss, _ = default._step.train_step(state, *(c[i] for c in cols), 1e-3)
        other, loss_c, _ = capped._step.train_step(other, *(c[i] for c in cols), 1e-3)
        rel = abs(float(loss_c) - float(loss)) / abs(float(loss))
        worst["loss"] = max(worst["loss"], rel)
        if rel > 1e-6:
            raise AssertionError(f"step {i}: capped loss {float(loss_c)} vs {float(loss)}")
        for k in ("user_emb", "anime_emb"):
            for a, c in ((getattr(other.model, k).detach(), getattr(state.model, k).detach()),
                         (other.adam.mu[k], state.adam.mu[k]), (other.adam.nu[k], state.adam.nu[k])):
                excess = ((a - c).abs() - (1e-6 + 1e-5 * c.abs())).max()
                worst["tables"] = max(worst["tables"], float((a - c).abs().max()))
                if float(excess) > 0:
                    raise AssertionError(f"step {i}: {k} differs between the capacities")
    launches = dict(_kernels.launches)
    if launches != {"fused_adam_tiles": AGREE_STEPS * 4, "fused_adam": AGREE_STEPS * 2,
                    "fused_adam_dense": AGREE_STEPS * 2}:
        raise AssertionError(f"agreement steps launched {launches}")
    return dict(steps=AGREE_STEPS, largest_loss_rel_gap=worst["loss"],
                largest_table_abs_gap=worst["tables"], launches=launches)


def phase_routed(card: str, trained: dict) -> dict:
    """7b: the routed trainer through PipelineRunner.step_train: with a
    process group and parallel.capacity set, step_train takes it."""
    import torch

    from anime_recommendations_tpu_torch.config import Config
    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.parallel import routing as rt
    from anime_recommendations_tpu_torch.pipeline.runner import PipelineRunner, store_root

    train, _ = _train_split()
    steps = -(-len(train) // BATCH)
    runs = [(opt, None) for opt in OPTIMIZERS] + [(opt, CAPPED) for opt in FUSED]
    default = rt.default_capacity(BATCH, 1)   # what capacity None resolves to
    out = {"rounds_at_capped": _rounds(CAPPED), "launches": {}, "history_gap": {}, "timed": {}}
    if min(lo for lo, _ in out["rounds_at_capped"].values()) <= 4:
        raise AssertionError(f"capacity {CAPPED} does not force > 4 rounds: "
                             f"{out['rounds_at_capped']}")
    print(f"[phase 7] rounds per batch at capacity {CAPPED} (least, most): "
          f"{json.dumps(out['rounds_at_capped'])}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        _write_store(store_root(Config(), tmp))
        for optimizer, capacity in runs:
            label = optimizer if capacity is None else f"{optimizer}@{capacity}"
            cfg = Config().with_overrides([
                f"model.optimizer={optimizer}", "model.epochs=1", "model.export_weight_csvs=false",
                "model.device_loop=true", f"parallel.capacity={capacity or default}"])
            runner = PipelineRunner(cfg, tmp, device=DEVICE)
            _kernels.launches.clear()
            result, seconds = _host_timed(runner.step_train)
            launches = {k: _kernels.launches[k]
                        for k in ("fused_adam_tiles", "fused_adam", "fused_adam_dense")}
            want = {"fused_adam_tiles": 0, "fused_adam": 0, "fused_adam_dense": 0}
            if optimizer in FUSED:
                want["fused_adam" if capacity is None else "fused_adam_dense"] = 2 * steps
                want["fused_adam_tiles"] = 2 * steps
            if launches != want or _kernels.launches["fused_adam_gather"]:
                raise AssertionError(f"routed {label}: launches {dict(_kernels.launches)}, "
                                     f"expected {want}")
            out["launches"][label] = launches
            hist = result.history
            if len(hist) != 1 or not np.isfinite(hist.to_numpy()).all():
                raise AssertionError(f"routed {label}: history {hist.to_dict('list')}")
            ref = trained["history"][optimizer].iloc[:1]
            gap = _history_gap(hist, ref)
            tol = BF16M_TOL if optimizer == "fused_adam_bf16m" else FUSED_TOL
            out["history_gap"][label] = gap
            print(f"[phase 7] routed {label}, world size 1 on NCCL: {json.dumps(launches)} over "
                  f"{steps} steps, fit in {seconds:.1f} s; history {json.dumps(hist.to_dict('list'))}; "
                  f"largest relative gap to phase 5's first epoch {json.dumps(gap)}, accepted "
                  f"{json.dumps(tol)}", flush=True)
            if any(gap[c] > tol[c] for c in tol):
                raise AssertionError(f"routed {label}: history does not track phase 5's")
            if optimizer == "fused_adam_bf16m" and result.state.adam.mu["user_emb"].dtype != torch.bfloat16:
                raise AssertionError("routed fused_adam_bf16m: table moments are not bf16")
    out["agree"] = _agree_steps()
    print(f"[phase 7] {AGREE_STEPS} steps, each from one state at the default capacity and at "
          f"{CAPPED}: {json.dumps(out['agree'])}", flush=True)
    for optimizer, capacity in [(opt, None) for opt in OPTIMIZERS] + [("fused_adam", CAPPED)]:
        label = optimizer if capacity is None else f"{optimizer}@{capacity}"
        out["timed"][label] = _timed_routed_epoch(optimizer, capacity)
        base = trained["timed"][optimizer]["ms_per_step"]
        print(f"[phase 7] routed {label} timed epoch ({card}): {json.dumps(out['timed'][label])}; "
              f"one-device (phase 5) {base:.3f} ms/step", flush=True)
    return out


# ---- phase 8 -------------------------------------------------------------------

ZIPF_EPOCHS, ZIPF_LR = 6, 3e-4
# BENCH_r05.json's overlaps on the same protocol (the JAX package on its
# TPU): what the port's trained-table overlaps are set beside.
ZIPF_RECORDS = {"f32_q256_vs_exact": 0.99961, "f32_one_query_vs_exact": 0.99961,
                "bf16_q256_vs_f32_exact": 0.99844, "bf16_q256_vs_bf16_exact": 0.99961,
                "int8_q256_vs_exact": 0.99961, "int8_q8_vs_exact": 1.0}


def _overlap(got, want) -> float:
    """Mean share of each query's reference top-k rows returned."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    return float(np.mean([len(set(g) & set(w)) / want.shape[1] for g, w in zip(got, want)]))


def phase_trained(card: str) -> dict:
    """bench.py:570-692's protocol at 91,641 users through the port: 6
    fused_adam epochs at lr 3e-4 over _zipf_ratings (batch 10,000, l2 1e-4,
    shuffled with seed 1), then the 256 hottest users' top-10 on the
    shuffled normalized user table (ops/topk.shuffle_rows, seed 13) against
    exact_scan=True: f32 at Q=256 (tensor cores) and one query at a time
    (streaming), bf16 against the f32 and the bf16 exact scans, int8 at
    Q=256 and Q=8. Counters are reset before the training: K1 (its first
    pass and the update) twice a step. Every overlap but bf16 against the
    f32 exact scan (storage, not extraction) must reach its BENCH_r05
    record, and the tensor-core branch may lose no exact row that the
    streaming branch keeps."""
    import torch

    from anime_recommendations_tpu_torch.data.dataset import RatingsDataset
    from anime_recommendations_tpu_torch.models.two_tower import normalized_tables
    from anime_recommendations_tpu_torch.ops import _kernels, topk
    from anime_recommendations_tpu_torch.ops.quantized import quantize_rows
    from anime_recommendations_tpu_torch.train import device_loop as dl
    from anime_recommendations_tpu_torch.train import trainer as tr

    users, anime, ratings = _zipf_ratings()
    ds = RatingsDataset(users=users, anime=anime, ratings=ratings)
    state = tr.init_train_state(N_USERS, N_ANIME, D, generator=torch.Generator().manual_seed(6),
                                device=DEVICE)
    data = dl.stage(ds, BATCH, seed=1, device=DEVICE)
    steps = data.n // BATCH
    _kernels.launches.clear()
    epoch_ms = []
    for ep in range(ZIPF_EPOCHS):
        (state, losses, _, _), seconds = _host_timed(lambda: dl.train_epoch(
            state, data, torch.Generator().manual_seed(100 + ep), ZIPF_LR, BATCH, 1e-4,
            optimizer="fused_adam"))
        epoch_ms.append(seconds * 1e3 / steps)
    launches = {k: _kernels.launches[k] for k in ("fused_adam_tiles", "fused_adam")}
    if launches != dict.fromkeys(launches, 2 * steps * ZIPF_EPOCHS):
        raise AssertionError(f"zipf training launched {launches} over {steps * ZIPF_EPOCHS} steps")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("zipf training: non-finite loss")
    out = {"card": card, "steps": steps * ZIPF_EPOCHS, "launches": launches,
           "ms_per_step_by_epoch": epoch_ms, "last_loss": float(losses[-1])}

    _, user_n = normalized_tables(state.model)
    hot = user_n[:256].contiguous()            # the hottest users: the lowest ids
    _, exact = topk.masked_topk(user_n, hot, 10, exact_scan=True)
    sh = topk.shuffle_rows(user_n, seed=13)
    _kernels.launches.clear()
    _, tc = topk.cosine_topk(sh, hot, 10)
    one = torch.cat([topk.cosine_topk(sh, hot[i:i + 1], 10)[1] for i in range(hot.shape[0])])
    if (_kernels.launches["packed_topk_mma"], _kernels.launches["packed_topk"]) != (1, 256):
        raise AssertionError(f"the f32 scans did not take both K2 branches: {_kernels.launches}")
    sh_b = topk.ShuffledTable(sh.table.to(torch.bfloat16), sh.perm, sh.inv)
    _, bf = topk.cosine_topk(sh_b, hot, 10)
    _, bf_exact = topk.masked_topk(sh.table.to(torch.bfloat16), hot.to(torch.bfloat16), 10,
                                   exact_scan=True)
    _, bf_phys = topk.masked_topk(sh.table.to(torch.bfloat16), hot.to(torch.bfloat16), 10)
    sh_q = topk.ShuffledTable(quantize_rows(sh.table), sh.perm, sh.inv)
    _, q256 = topk.cosine_topk(sh_q, hot, 10)
    _, q8 = topk.cosine_topk(sh_q, hot[:8], 10)
    out["overlaps"] = {
        "f32_q256_vs_exact": _overlap(tc, exact),
        "f32_one_query_vs_exact": _overlap(one, exact),
        "bf16_q256_vs_f32_exact": _overlap(bf, exact),
        "bf16_q256_vs_bf16_exact": _overlap(bf_phys, bf_exact),
        "int8_q256_vs_exact": _overlap(q256, exact),
        "int8_q8_vs_exact": _overlap(q8, exact[:8]),
    }
    out["records"] = ZIPF_RECORDS
    # Exact rows the tensor-core branch loses that the streaming one keeps.
    lost = sum(len((set(e) & set(s)) - set(t)) for e, s, t in zip(
        exact.tolist(), one.tolist(), tc.tolist()))
    out["tensor_core_losses_streaming_keeps"] = lost
    print(f"[phase 8] {json.dumps(out)}", flush=True)
    # bf16 against the f32 exact scan measures the table's storage as well
    # (bf16 rows reorder near-ties); the extraction's own loss is bf16
    # against the bf16 exact scan, which is held to its record.
    below = {k: v for k, v in out["overlaps"].items()
             if v < ZIPF_RECORDS[k] and k != "bf16_q256_vs_f32_exact"}
    if below or lost:
        raise AssertionError(f"trained-table overlaps below BENCH_r05's {below}, "
                             f"{lost} rows lost by the tensor-core branch alone")
    return out


def main() -> int:
    card = phase_device()
    import torch

    from anime_recommendations_tpu_torch.ops import _kernels

    rows = phase_kernels(card)
    new_rows = phase_new_kernels(card)
    _kernels.launches.clear()
    phase_slice(card)
    serving_launches = dict(_kernels.launches)
    print(f"[phase 3] launches on the serving path: {json.dumps(serving_launches)}", flush=True)
    for name in (*K2_COUNTERS, "packed_topk_int8", "exact_topk"):
        if serving_launches.get(name, 0) < 1:
            raise AssertionError(f"the serving path never launched {name}")
    if serving_launches.get("l2_normalize", 0) != 2 * len(CONTEXTS):
        raise AssertionError("the context builds did not launch l2_normalize twice each")
    adam_rows, gather_rows = phase_adam(card)
    # 7a's timed dense cases here, beside phase 4's: after phase 6, sessions
    # of torch.profiler lose a few records of every kernel in this process.
    dense_rows = phase_dense(card, receipts=False)
    _kernels.launches.clear()
    trained = phase_train(card)
    if _kernels.launches["fused_adam"] < 1:
        raise AssertionError("the training path never launched fused_adam")
    gathered = phase_gather(card)   # resets the counters before each epoch
    phase_convergence(card)
    import torch.distributed as dist

    init_nccl()
    try:
        dense_rows += phase_dense(card, receipts=True)
        routed = phase_routed(card, trained)   # resets the counters before each run
    finally:
        dist.destroy_process_group()
    phase_trained(card)
    # K2's two kernels: the streaming one (one query; users f32 Q=1) and the
    # tensor-core one (more; users f32 Q=256, bound by TF32).
    kernels = []
    for name, branch, case in (("packed_topk", "small_q", "users_f32_q1_exclude"),
                               ("packed_topk_mma", "tensor_core", "users_f32_q256_exclude")):
        ref = next(r for r in rows if r["case"] == case)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "anime_recommendations_tpu_torch/csrc/packed_topk.cu",
            "replaces": "anime_recommendations_tpu/ops/topk.py:185",
            "launches": serving_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["branch"] == branch),
            "ms": ref["ms"],
            "plain_ms": ref["plain_ms"],
            "bound_ms": ref["bound_ms"],
            "bound_by": ref["bound_by"],
            "library_ms": None,   # no single PyTorch call makes stage-1 candidates
        })
    for name, case, replaces in (
        ("packed_topk_int8", "users_int8_q1_exclude", "anime_recommendations_tpu/ops/topk.py:219"),
        ("exact_topk", "users_f32_q1_exclude", "anime_recommendations_tpu/ops/topk.py:84"),
        ("l2_normalize", "users_f32_to_f32", "anime_recommendations_tpu/ops/normalize.py:20"),
    ):
        ref = next(r for r in new_rows[name] if r["case"] == case)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"anime_recommendations_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": serving_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in new_rows[name]),
            "ms": ref["ms"],
            "plain_ms": ref["plain_ms"],
            "bound_ms": ref["bound_ms"],
            "bound_by": ref["bound_by"],
            # Only K4 has one PyTorch call of the same function.
            "library_ms": ref.get("library_ms"),
        })
    for name, replaces, case_rows, launches in (
        ("fused_adam", "anime_recommendations_tpu/ops/fused_adam.py:71", adam_rows,
         lambda opt: trained["launches"][opt]),
        ("fused_adam_gather", "anime_recommendations_tpu/ops/fused_adam.py:189", gather_rows,
         lambda opt: gathered[opt]["kernel_gather"]["launches"]["fused_adam_gather"]),
    ):
        for label, optimizer, sr in (("f32 moments", "fused_adam", False),
                                     ("bf16 moments, stochastic rounding", "fused_adam_bf16m", True)):
            cases = [r for r in case_rows if r["sr"] == sr]
            users = next(r for r in cases
                         if r["case"].startswith("users") and "one_id" not in r["case"])
            kernels.append({
                "name": f"{name} ({label})",
                "route": "cuda",
                "source": "anime_recommendations_tpu_torch/csrc/fused_adam.cu",
                "replaces": replaces,
                "launches": launches(optimizer),
                "max_abs_err": max(r["max_abs_err"] for r in cases),
                "ms": users["ms"],
                "plain_ms": users["plain_ms"],
                "bound_ms": users["bound_ms"],
                "bound_by": users["bound_by"],
                # A scatter-add, the Adam math and a gather: no single call.
                "library_ms": None,
            })
    for label, optimizer, sr in (("f32 moments", "fused_adam", False),
                                 ("bf16 moments, stochastic rounding", "fused_adam_bf16m", True)):
        cases = [r for r in dense_rows if r["sr"] == sr]
        users = next(r for r in cases if r["case"].startswith("users") and "ms" in r)
        kernels.append({
            "name": f"fused_adam_dense ({label})",
            "route": "cuda",
            "source": "anime_recommendations_tpu_torch/csrc/fused_adam.cu",
            "replaces": "anime_recommendations_tpu/ops/fused_adam.py:71",
            "launches": routed["launches"][f"{optimizer}@{CAPPED}"]["fused_adam_dense"],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": users["ms"],
            "plain_ms": users["plain_ms"],
            "bound_ms": users["bound_ms"],
            "bound_by": users["bound_by"],
            # No single call: a scatter-add plus a dense add, then the Adam math.
            "library_ms": None,
        })
    # The two passes K1 (the first) and K5 (both) run around their update
    # kernels, each timed in K5's skewed anime case, where both work; the
    # entries above count them in their ms.
    k5_skewed = next(r for r in gather_rows if r["case"] == "anime_f32_skewed")
    for name, replaces, row, tag, launches in (
        ("fused_adam_tiles", "anime_recommendations_tpu/ops/fused_adam.py:71", k5_skewed,
         "tiles", trained["tile_launches"]["fused_adam"]),
        ("fused_adam_copies", "anime_recommendations_tpu/ops/fused_adam.py:189", k5_skewed,
         "copies", gathered["fused_adam"]["kernel_gather"]["launches"]["fused_adam_copies"]),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "anime_recommendations_tpu_torch/csrc/fused_adam.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r.get(f"{tag}_max_abs_err", 0.0) for r in adam_rows + gather_rows),
            "ms": row["by_kernel_ms"][f"{name}_kernel"],
            "plain_ms": row[f"{tag}_plain_ms"],
            **_bound(row[f"{tag}_bytes"], 0),
            # Segment sums of sorted runs; copies of rows: no single call.
            "library_ms": None,
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
