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
             packed_topk_int8 (K2q; INT8_CASES), int8 tables, both of its
               kernels: packed_topk_int8_kernel (dp4a) for one query, and
               from ops/topk.INT8_MMA_MIN_Q = 2 queries
               packed_topk_int8_mma_kernel on the int8 tensor cores, keys
               bit-equal to the plain version's without a head on both, a k
               that drives top_r above 64;
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
           scanning request must launch its context's scan kernel once
           (packed_topk or packed_topk_mma, packed_topk_int8 or
           packed_topk_int8_mma, exact_topk; each of them at least once in
           the phase), counted per replay, and every scanning endpoint must
           be served by a replay of its context's scan graph
           (ops/scan_graph.py; a batch request is sent three times: eager,
           captured, replayed); every context build launches l2_normalize
           twice (the anime and the user table). Each context's graphs
           held, hits, misses, captures, their seconds and pool MB are
           printed, and the graphs released with the context.
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
  phase 4b the dense Adam kernel (csrc/dense_adam.cu; it replaces no Pallas
           kernel) against its plain version, the torch chain, on the card:
           the adam cell's update (the 91,641 x 128 and 17,560 x 128 tables
           and the four head scalars in one launch) and the head scalars
           alone, three steps from one state, p, mu and nu bit for bit; the
           kernel's device time, the chain's, 28 bytes an element against
           3.35 TB/s and the share of that bound, both CUDA-event medians.
  phase 4c the row-sparse Adam kernel (csrc/lazy_adam.cu; it replaces no
           Pallas kernel) at the lazy cell's shapes: tables of 1,000,990 and
           624,961 rows of 128, 10,000 ids each (users uniform, items
           Zipf-0.8), both tables in one launch, against its plain version,
           the torch chain, on the card: rows hit once bit for bit, every
           row within 1e-5 of each tensor's largest entry, a second launch
           from the same state bit for bit the first; the kernel's device
           time, the whole call's (the id sort included) and the chain's
           over 8 steps' ids (the touched rows out of L2), both CUDA-event
           medians, and the step's bytes against 3.35 TB/s.
  phase 5  training end to end at full width: PipelineRunner.step_train on
           phase 3's store, 2 epochs of 297 batches of 10,000 rows, once per
           optimizer (adam, lazy_adam, fused_adam, fused_adam_bf16m; one
           seed, the device loop, whose fused epochs are the software-
           pipelined loop). Launch counters are reset before it: each fused
           step must launch K1 twice, adam and lazy_adam never, and every
           step dense_adam once (adam's six parameters, the others' four
           head scalars), each lazy_adam step lazy_adam once (both tables),
           the others never. The fused
           histories must track the dense one, lazy_adam's training loss must
           fall from epoch 1 to 2, the bf16m state must hold bf16 table
           moments, and the trained store must serve every endpoint through
           the HTTP server in agreement with the dense oracle. On the card
           each epoch is the replay of a CUDA graph (train/device_loop.py),
           whose launches the counters add per replay. Its timing is phase
           13's (the captured epoch's ms per step, device-busy time and idle
           shares).
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
           phase 5's tolerances (on the card each of these epochs is the
           replay of a CUDA graph with its NCCL collectives, after the
           replay of its batches' graph). Then 20 steps, each from one state
           at both capacities, agree (loss 1e-6 relative, tables 1e-6
           absolute + 1e-5 relative: tests/test_parallel.py's). Then, per
           optimizer and for fused_adam at 512 slots, two epochs of the
           first 60 batches (lr 1e-5, then 2e-5) through the eager loops and
           two through the graphs (the first captures them), from one state
           and one shuffle, and an evaluation of the holdout after them: the
           captured epochs must be bit-equal to the eager ones (every state
           tensor, loss, mse and the validation pair; lazy_adam within 1e-5
           of each tensor's scale, its atomics, but for dense_b's noise
           walk), replay the epoch's graph once per epoch, and launch K1 (or
           its dense branch) and its first pass as often as the eager loop;
           each one's ms per step (the second epoch), 10 steps under
           torch.profiler (device-busy ms, idle shares), peak memory, host
           reads per epoch and the graphs' capture seconds and pool sizes,
           beside phase 13's one-device step.
  phase 8  a table trained on skewed ids, served: bench.py:570-692's
           protocol at 91,641 users (6 fused_adam epochs at lr 3e-4 over 2M
           ratings of pareto-skewed ids, through K1; ms per step), then the
           256 hottest users' top-10 on the shuffled user table against the
           exact scan: f32 at Q=256 (tensor cores) and one query at a time,
           bf16 against the f32 and the bf16 exact scans, int8 at Q=256 and
           Q=8 (both on the int8 tensor cores), beside BENCH_r05's records
           (phase_trained says which must reach them).
  phase 9  the whole pipeline and IVF retrieval. 9a: PipelineRunner.run()
           over the eight steps at phase 3's scale (91,641 x 17,560 x 3M
           synthetic ratings, seed 7, every user kept), D = 128, batches of
           10,000, fused_adam, depth cut to one epoch. Counters are reset
           before it; each step's launches are read: K1 and its first pass
           twice per training step and dense_adam once (the head),
           l2_normalize twice for the context build, K2 in similar_anime,
           similar_users, user_recs (a random user outside the flow, whose
           similar users it scans) and model_recs. Every artifact of tests/test_pipeline.py:91-101 must
           exist (the PNGs only where matplotlib is installed; the skipped
           ones are printed), the history header must be the golden one,
           assert_flow must hold, and the similar_anime, similar_users and
           model_recs CSVs must match a dense oracle on the card from the
           stored weights. timings.json, the StepTimer sections and the
           card's memory are printed. Then ``cli pipeline`` over the five
           recommend steps runs in a subprocess on the same run: the same
           seed makes the same picks, so its CSVs must equal the first
           run's. 9b: on the trained store, an f32 IVF context probing
           every cluster must answer every endpoint of the HTTP server as
           the exact context does; an int8 IVF context (probing every
           cluster is not exact there) must give the CPU's results on the
           same indexes; the default 16 probes' overlap with the exact
           context is printed. Then bench.py:467-517's protocol from this
           script's seed: 2,000,000 x 128 unit rows from a rank-16 latent,
           build_ivf(2048 clusters, 8 iterations, seed 3), 64 queries'
           recall@10 at 8 and 32 probes against K3's exact scan (at least
           BENCH_r05's 0.7109 and 0.9438 less 0.03), the build seconds and
           the device ms of one query at p8, p32 and through the exact
           scans, beside the card's name and power limit.
  phase 10 (on phase 7's NCCL group, after it) the rest of parallel/, take_rows
           and the asynchronous checkpointer, at full width. 10a:
           PipelineRunner.step_train with parallel.routing=psum, then with
           parallel.shard_anime_table=true too: one adam epoch each, held to
           phase 5's first adam epoch at phase 5's tolerances; ShardedTrainer
           with psum must refuse lazy_adam and fused_adam; then psum adam,
           eager against captured as in 7b (bit-equal, one replay per
           epoch, the same numbers). 10b: parallel/scaling_bench's measure_mesh
           at 1x1 with its defaults (91,641 x 17,560 x 128, batches of 8,192,
           30 steps after 3): alltoall adam, alltoall fused_adam (K1 and its
           first pass twice a step) and psum adam, then its launcher (one
           torch.distributed.run of one NCCL rank) at 1x1 psum. 10c: the
           device loop's adam with sorted_scatter True (two_tower.take_rows)
           and False: Trainer.fit histories within 1e-5 relative, a timed
           epoch each (the second from a fresh state: a replay of its
           graph) with 10 profiled steps, and the two tables' embedding
           backward alone on a batch's ids (through take_rows and the
           plain gather: autograd's index_put_ either way), within 1e-6 of
           the largest entry, profiled. 10d:
           Trainer.fit with AsyncCheckpointer: the saved best state restores
           bit for bit, a fit stopped after 2 epochs and resumed equals the
           uninterrupted 3-epoch fit bit for bit, a snapshot ignores an
           in-place update made before its write, and the host time save
           blocks against Checkpointer.save's. Counters are reset before
           the phase: K1 and its first pass must run 66 times each (10b's
           fused_adam), no other kernel.
  phase 11 the benchmark suite: ``python -m anime_recommendations_tpu_torch.cli
           bench`` (the port of bench.py, at bench.py's sizes) in a fresh
           process with its own time limit. Its stdout must be one JSON line
           holding every key bench.py writes (read from bench.py's source) but
           scan_harness_base_ms and no other, with the card in ``device``;
           topk_overlap_vs_oracle, topk_q256_overlap_vs_oracle and
           score_topk_overlap_vs_oracle must read 1.0, the four trained-table
           overlaps of phase 8's records at least 0.99961, IVF recall@10 at
           least 0.68 (8 probes) and 0.91 (32); its ``[bench] launches`` line
           must show K1, both K2 branches, both K2q branches, K3 and K4. Its
           section times, keys and launches are printed. Section 5's routed
           epochs are graph replays (parallel/sharded_train.run_epoch).
  phase 12 the downloaded dataset: phase 3's raw frames (3,000,000 synthetic
           ratings of seed 7, the ratings as a numeric CSV) served by a
           ThreadingHTTPServer on 127.0.0.1 in a thread of this script, and
           PipelineRunner over ingest, preprocess, train and similar_anime
           with phase 9's configuration (D = 128, fused_adam, one epoch),
           downloading allowed, the three URLs set and every local path
           missing, a random query title and no weight CSVs. The cache must
           hold the served bytes, full_data_set.parquet be tagged
           "download" and hold the served CSV as read locally, and each step
           launch as in 9a (K1 and its first pass twice per training step,
           K4 twice, K2 at least once). Then ``cli ingest`` in a subprocess
           against the same server must write the same full_data_set.parquet.
           The phase's seconds, ingest's and the download's MB/s (the
           cached bytes over the time of the client's _download calls) are
           printed.
  phase 13 the captured epoch (right after phase 5): at phase 5's full width
           (297 batches of 10,000), per optimizer, two epochs (lr 1e-5, then
           2e-5) through the eager loop (dl.eager_train_epoch), two more
           from the same state and shuffle generators, and two through the
           CUDA graph (dl.train_epoch: the first captures it, each replays
           it). The largest gap, captured against eager and eager against
           the repeat, of the per-batch losses and mses, the tables, their
           moments, the head scalars and their moments, the BatchNorm stats
           and the Adam count: the fused optimizers' must be bit-equal, and
           adam's and lazy_adam's too wherever the two eager runs are, else
           within 1e-5 of each tensor's scale but for dense_b, its moments
           and moving_mean, which walk on rounding noise (printed). ms per
           step of each second epoch (host clock between synchronizes), 10 steps of each under
           torch.profiler (device-busy ms per step, idle shares), the warm-up,
           capture and instantiation seconds, the peak memory of each run,
           the graph's replays per epoch and K1's and its first pass's
           launches per replay (2 x steps for the fused optimizers, and the
           counters' totals those of the eager loop), and the host's cost of
           a step row and of an epoch's scalar table.
  phase 14 captured scans (right after phase 3): one retrieval request as
           one CUDA graph replay (ops/scan_graph.py), at full width (91,641
           x 128 users, 17,560 x 128 anime: phase 3's model, seed 7),
           every flavour a context serves: f32 and bf16 (both K2 branches),
           int8 (both K2q branches), the exact scan (K3), IVF with f32 and
           int8 storage at 8 probes and probing every cluster; four
           requests (a bare user scan; similar users, with exclude; similar
           anime, with mask and exclude; model recs, with head and mask) at
           Q = 1, 2, 64, 256 and k = 10, 50. Each request: the eager body
           (scan_graph.EAGER), then a cache's first call (eager), its capture
           and a replay, each bit for bit the eager body's. For the similar
           users and model recs requests at k = 10, per flavour and Q, eager
           against replayed: host ms per scan (a synchronize on both sides,
           median of 10 taken in turns), the host's launches and the
           device's kernels per scan and device-busy ms and idle share
           (utils/profiling.profiled); per request kind, the captures'
           seconds and pool MB. Then a fresh f32 context's HTTP server
           answers 8 threads of mixed requests to every endpoint while its
           first captures happen, each answer equal to an eager context's
           (RecContext.scan_graphs = ScanGraphs(0)) on the same store, and
           each endpoint's median and p90 latency over 100 requests through
           both servers, taken in turns, with the share a replay served.

  phase 15 each training and evaluation step as one CUDA graph replay
           (train/step_graph.py; right after phase 13), at phase 13's full
           width and initial state (91,641 x 17,560 x 128, batches of
           10,000 of phase 5's training split, seed 7): per entry point
           (train_step with adam, lazy_train_step, fused_train_step with
           f32 and bf16 moments, fused_train_step_pipelined without and
           with K5's gather) 20 calls eagerly (step_graph.EAGER) and 20
           through a step-graph cache from one state on the same numpy
           batches, lr 1e-5 and 2e-5 in turn, the launch counters set to 0
           before each run and read after: every state tensor, loss and
           mse bit-equal (lazy_adam within 1e-5 of each tensor's scale, the
           head scalars of the largest of them, but for dense_b's noise
           walk), K1 and its first pass (K5 and its
           passes with the gather) launched twice a call, counted per
           replay, one capture and a replay per call from the second on;
           ms per step over calls 3-20 (host clock between synchronizes),
           10 more calls of each under torch.profiler (device-busy ms, idle
           share, host launches a step), capture and instantiation
           seconds, pool MB. 15b (on phase 7's NCCL group, after 7b): the
           same for ShardedTrainStep.train_step at world size 1, routed
           fused_adam at the default capacity and at 512 slots (each call
           reads its round counts before its replay) and psum adam, then
           eval_sums and grads three calls each through the cache, bit for
           bit the eager calls.

The last lines are the card line, a JSON line of kernel results (each
kernel's launches on its path, largest error against its plain version, its
time, the plain version's, the least time the card could take for the work
at 3.35 TB/s and the data sheet's peak rates, and one PyTorch call's time
where one computes the same function; K1's, its dense branch's and K5's
times are those of all the kernels a call launches, their passes included,
which are listed on their own too), and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
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

from anime_recommendations_tpu_torch.bench import HBM_BYTES_PER_S  # noqa: E402
from anime_recommendations_tpu_torch.utils.profiling import (  # noqa: E402
    profiled as _profiled,
    start_profiler,
)

N_USERS, N_ANIME, N_RATINGS, D = 91_641, 17_560, 3_000_000, 128
SEED = 7
TIMED_RUNS = 20
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


# ---- phase 2 -------------------------------------------------------------------

# Phase 2's scan cases, K2 (k2_cases), K3 (K3_CASES) and K2q (INT8_CASES):
# (name, table, dtype, Q, k, features); features "exclude" (each query's own
# row, from the user table) or "head_mask" (the sigmoid head and an anime
# mask keeping ~80 % of the rows). tools/scan_kernels.py times the same cases.
DTYPES = {"f32": "float32", "bf16": "bfloat16"}
# K2's launch counters: the streaming branch (one query) and the
# tensor-core branch (more), as ops/topk._packed_candidates_cuda counts them;
# K2q's: dp4a (one query) and the int8 tensor cores (from INT8_MMA_MIN_Q).
K2_COUNTERS = ("packed_topk", "packed_topk_mma")
INT8_COUNTERS = ("packed_topk_int8", "packed_topk_int8_mma")


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


# Both sides of ops/topk.INT8_MMA_MIN_Q = 2 (Q = 1 and 8), one 64-query tile
# and four, and the k = 600 model_recs_batch depth.
INT8_CASES = _named([("users", "int8", q, 10, "exclude") for q in (1, 8, 64, 256)]
                    + [("anime", "int8", q, k, "head_mask")
                       for q, k in ((1, 10), (64, 10), (16, 600))])


def _case_inputs(rng, tables, case, head, anime_mask):
    """(table, queries, kwargs) of a phase-2 case: queries are user rows. An
    int8 case takes ``tables`` of QuantizedTables, and f32 user rows."""
    import torch

    _, which, dtype, q, _, features = case
    table = tables[which] if dtype == "int8" else tables[which].to(getattr(torch, DTYPES[dtype]))
    users = tables["users"].f32 if dtype == "int8" else tables["users"]
    idx = torch.from_numpy(rng.choice(N_USERS, size=q, replace=False)).to(users.device)
    kw = dict(exclude=idx) if features == "exclude" else dict(mask=anime_mask, head=head)
    return table, users[idx], kw


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
    qn = queries.shape[0]
    r = topk.top_r_policy(k, n)
    big = qn >= topk.INT8_MMA_MIN_Q
    counter = INT8_COUNTERS[big]
    before = _kernels.launches[counter]
    v, i = quantized.quantized_topk(qt, queries, k, mask=mask, exclude=exclude, head=head)
    torch.cuda.synchronize()
    if _kernels.launches[counter] <= before:
        raise AssertionError(f"{name}: quantized_topk did not launch {counter}")
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
    row = dict(card=card, case=name, n=n, q=qn, k=k, top_r=r,
               branch="tensor_core" if big else "small_q", max_abs_err=err, key_err=key_err,
               overlap=overlap)
    row |= _timing(lambda: topk._packed_candidates_int8_cuda(*args, q_scale, qt.scale),
                   lambda: topk._packed_candidates_plain(*args, q_scale, qt.scale),
                   f"{counter}_kernel")
    row["quantized_topk_ms"] = _median_ms(lambda: quantized.quantized_topk(
        qt, queries, k, mask=mask, exclude=exclude, head=head))
    row["quantized_topk_plain_ms"] = _median_ms(plain)
    # The table (int8 rows and f32 row scales) is read once per query tile
    # of 1, 16 or 64 queries, as the kernel's own rule picks it (the tensor
    # cores' tiles of one group run side by side and share its rows in L2).
    row["tile"] = _kernels.library("packed_topk_int8").packed_topk_int8_query_tile(n, qn)
    row["table_reads"] = -(-qn // row["tile"])
    row["bytes_read"] = _nbytes(qt.q, qt.scale) * row["table_reads"]
    row["hbm_share"] = row["bytes_read"] / (row["ms"] * 1e-3) / HBM_BYTES_PER_S
    row |= _scan_bound(_nbytes(qt.q, qt.scale, q_scale), q_int, mask, exclude, _nbytes(kk),
                       *qt.q.shape, kind="int8")
    row["bound_share"] = row["bound_ms"] / row["ms"]
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
    qtables = {"users": quantized.quantize_rows(users), "anime": quantized.quantize_rows(anime)}
    for case in INT8_CASES:
        table, queries, kw = _case_inputs(rng, qtables, case, head, anime_mask)
        out["packed_topk_int8"].append(_int8_case(card, case[0], table, queries, case[4], **kw))
    tables = {"users": users, "anime": anime}
    for case in K3_CASES:
        table, queries, kw = _case_inputs(rng, tables, case, head, anime_mask)
        out["exact_topk"].append(_exact_case(card, case[0], table, queries, case[4], **kw))
    if max(r["top_r"] for r in out["packed_topk_int8"]) <= 64:
        raise AssertionError("no K2q case drove top_r above 64")
    if {r["branch"] for r in out["packed_topk_int8"]} != {"small_q", "tensor_core"}:
        raise AssertionError("phase 2 did not drive both K2q branches")
    return out


# ---- phase 3 -------------------------------------------------------------------

@functools.cache
def _raw_frames():
    """The synthetic raw ratings, catalog and synopses at reference scale
    (made once, from SEED): what the pipeline's ingest makes of the default
    config with phase 9's sizes."""
    from anime_recommendations_tpu_torch.data import synthetic

    raw = synthetic.synth_ratings(n_users=N_USERS, n_anime=N_ANIME,
                                  n_interactions=N_RATINGS, seed=SEED)
    catalog = synthetic.synth_anime_catalog(n_anime=N_ANIME, seed=SEED)
    return raw, catalog, synthetic.synth_synopses(catalog, seed=SEED)


@functools.cache
def _dataset():
    """The synthetic ratings at reference scale, preprocessed, with vocab,
    catalog and synopses (made once, from SEED)."""
    from anime_recommendations_tpu_torch.data.preprocess import preprocess_ratings
    from anime_recommendations_tpu_torch.data.vocab import build_vocab

    t0 = time.perf_counter()
    raw, catalog, synopses = _raw_frames()
    clean, _ = preprocess_ratings(raw, num_reviews=1)
    vocab = build_vocab(clean)
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


def _model_arrays() -> dict:
    """The served model's parameters, from SEED, at _dataset()'s vocab sizes
    (the JAX package's .npz keys)."""
    _, vocab, _, _ = _dataset()
    rng = np.random.default_rng(SEED)
    return {
        "user_emb": rng.uniform(-0.05, 0.05, (vocab.n_users, D)).astype(np.float32),
        "anime_emb": rng.uniform(-0.05, 0.05, (vocab.n_anime, D)).astype(np.float32),
        "dense_w": np.float32(1.7), "dense_b": np.float32(-0.3),
        "bn_gamma": np.float32(0.9), "bn_beta": np.float32(0.2),
        "moving_mean": np.float32(0.1), "moving_var": np.float32(1.4),
    }


def _write_store(root: Path) -> None:
    """A run directory in the JAX pipeline's artifact-store layout, holding
    what its ingest, preprocess and train steps write."""
    clean, vocab, catalog, synopses = _dataset()
    arrays = _model_arrays()

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


SCANNING = ("similar_anime", "similar_users", "user_recs", "model_recs", "similar_anime_batch",
            "model_recs_batch", "similar_users_batch")
BATCH_REPEATS = 3   # a batch request's first call scans eagerly, its second captures


def _drive_endpoints(ctx, cfg, label, kernels=K2_COUNTERS) -> dict:
    """Every endpoint through the HTTP server, checked against the oracle;
    each scanning request must launch exactly one of ``kernels`` (launch
    counter names) once, and each scanning endpoint must be served by a
    replay of its scan graph (ctx.scan_graphs) at least once: a batch
    request is sent BATCH_REPEATS times, each answer the first's. Returns
    per-endpoint median latency (ms, host clock around the request)."""
    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.recommend.user_recs import user_recs
    from anime_recommendations_tpu_torch.serve.api import make_server

    server = make_server(ctx, cfg, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    latency: dict[str, list[float]] = {}
    replayed: dict[str, int] = {}

    def get(endpoint, scans=True, **params):
        url = f"{base}/{endpoint}?{urllib.parse.urlencode(params)}"
        before = sum(_kernels.launches[c] for c in kernels)
        hits = ctx.scan_graphs.hits
        t0 = time.perf_counter()
        with urllib.request.urlopen(url, timeout=120) as resp:
            body = json.loads(resp.read())
        latency.setdefault(endpoint, []).append((time.perf_counter() - t0) * 1e3)
        launched = sum(_kernels.launches[c] for c in kernels) - before
        if scans and launched != 1:
            raise AssertionError(f"{label} /{endpoint}: {kernels} launched {launched} times, "
                                 "not once")
        replayed[endpoint] = replayed.get(endpoint, 0) + (ctx.scan_graphs.hits - hits)
        if not body:
            raise AssertionError(f"{label} /{endpoint}: empty answer")
        return body

    def get_batch(endpoint, **params):
        first = get(endpoint, **params)
        for _ in range(BATCH_REPEATS - 1):
            if get(endpoint, **params) != first:
                raise AssertionError(f"{label} /{endpoint}: a repeated request answered "
                                     "otherwise")
        return first

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
        batch = get_batch("similar_anime_batch", names="|".join(names[5:8]), k=10)
        for rec, name in zip(batch, names[5:8]):
            qi = ctx.anime_index(catalog.resolve_query(name))
            v, i = _oracle(anime, anime, qi, 10, ctx.in_catalog_mask())
            _close(f"{label} similar_anime_batch", rec["similarities"], v[0],
                   rec["anime_ids"], vocab.anime_ids[i[0]])
        batch = get_batch("model_recs_batch", user_ids=",".join(map(str, users[16:20])), k=10)
        for rec, uid in zip(batch, users[16:20]):
            mask = ctx.in_catalog_mask() & ~ctx.watched_mask(uid)
            v, i = _oracle(anime, users_t, ctx.user_index(uid), 10, mask,
                           exclude_self=False, head=ctx.head)
            _close(f"{label} model_recs_batch", rec["predictions"], v[0],
                   rec["anime_ids"], vocab.anime_ids[i[0]])
        batch = get_batch("similar_users_batch", user_ids=",".join(map(str, users[20:24])), k=10)
        for rec, uid in zip(batch, users[20:24]):
            v, i = _oracle(users_t, users_t, ctx.user_index(uid), 10)
            _close(f"{label} similar_users_batch", rec["similarities"], v[0],
                   rec["similar_users"], vocab.user_ids[i[0]])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    missed = [e for e in SCANNING if not replayed.get(e)]
    if ctx.device.type == "cuda" and missed:
        raise AssertionError(f"{label}: no request to {missed} was a replay of its scan graph")
    return {e: statistics.median(t) for e, t in latency.items()}


# label -> (similarity.retrieval_dtype, RecContext topk_kwargs, the scan
# kernels' launch counters)
CONTEXTS = {
    "f32": ("f32", None, K2_COUNTERS),
    "bf16": ("bf16", None, K2_COUNTERS),
    "int8": ("int8", None, INT8_COUNTERS),
    "exact_scan": ("f32", {"exact_scan": True}, ("exact_topk",)),
}


def phase_slice(card: str, device: str = "cuda") -> dict:
    import torch

    from anime_recommendations_tpu_torch.config import Config
    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.pipeline.runner import context_from_store, store_root

    latencies, graphs = {}, {}
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
            graphs[label] = ctx.scan_graphs.report()
            print(f"[phase 3] {label} scan graphs ({card}): {json.dumps(graphs[label])}",
                  flush=True)
            ctx.release_graphs()
            del ctx
    from anime_recommendations_tpu_torch.ops import scan_graph

    print(f"[phase 3] scan graphs held after the phase: {len(scan_graph.DEFAULT)} "
          "(the contexts' went with them)", flush=True)
    return {"latency_ms": latencies, "graphs": graphs}


# ---- phase 14 ------------------------------------------------------------------

# label -> (retrieval dtype, ann, _dispatch_topk keywords): every scan flavour
# a RecContext serves (probes None: every cluster).
SCAN_GRAPH_FLAVOURS = {
    "f32": ("f32", "off", {}),
    "exact": ("f32", "off", {"exact_scan": True}),
    "bf16": ("bf16", "off", {}),
    "int8": ("int8", "off", {}),
    "ivf_f32_p8": ("f32", "ivf", {"probes": 8}),
    "ivf_f32_all": ("f32", "ivf", {"probes": None}),
    "ivf_int8_p8": ("int8", "ivf", {"probes": 8}),
    "ivf_int8_all": ("int8", "ivf", {"probes": None}),
}
SCAN_GRAPH_Q = (1, 2, 64, 256)
SCAN_GRAPH_K = (10, 50)
# side -> (scanned table, the queries' table, mask, exclude, head): the
# recommenders' requests (numpy masks and exclusions, as they pass them).
SCAN_GRAPH_SIDES = {
    "users": ("user", "user", False, False, False),
    "similar_users": ("user", "user", False, True, False),
    "similar_anime": ("anime", "anime", True, True, False),
    "model_recs": ("anime", "user", True, False, True),
}
SCAN_TIMED_SIDES = ("similar_users", "model_recs")   # timed per flavour and Q, at k = 10
SCAN_TIMED_RUNS = 10   # calls per mode in a timing (probing every cluster, Q = 256: ~0.1 s each)
# Profiled calls of a scan slower than SCAN_HEAVY_MS (IVF probing every
# cluster, ~1,500-5,700 launches eager): the profiler's records of ten would
# take tens of seconds to sum.
SCAN_HEAVY_MS, SCAN_HEAVY_REPS = 10.0, 3
HTTP_SAMPLES = 100    # requests per endpoint and mode: p90 has 10 samples above it
HTTP_THREADS = 8


def _scan_tables(dtype: str, ann: str):
    """recommend/tables.build_tables of phase 3's model on the card."""
    from anime_recommendations_tpu_torch.models.two_tower import params_from_numpy
    from anime_recommendations_tpu_torch.recommend.tables import build_tables

    return build_tables(params_from_numpy(_model_arrays(), "cuda"), device="cuda",
                        retrieval_dtype=dtype, ann=ann)


def _scan_args(t, side: str, q: int, rng) -> tuple:
    """_dispatch_topk's (table, queries, mask, exclude, head) of one request."""
    import torch

    scanned, asking, has_mask, has_exclude, has_head = SCAN_GRAPH_SIDES[side]
    table = t.user_scan if scanned == "user" else t.anime_scan
    rows_of = t.user_norm if asking == "user" else t.anime_norm
    rows = rng.choice(rows_of.shape[0], size=q, replace=False)
    n = (t.user_norm if scanned == "user" else t.anime_norm).shape[0]
    return (table, rows_of[torch.from_numpy(rows).to(rows_of.device)],
            rng.uniform(size=n) > 0.2 if has_mask else None,
            rows if has_exclude else None, t.head if has_head else None)


def _host_ms(fns: dict, runs: int = TIMED_RUNS) -> dict:
    """Median host ms of each fn with a synchronize on both sides, the fns
    taken in turn (so drift touches each alike), after 3 calls of each."""
    import torch

    times = {name: [] for name in fns}
    for r in range(runs + 3):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if r >= 3:
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def _scan_flavour(card: str, label: str, t, kw: dict, rng) -> dict:
    """Every side, Q and k of one flavour: the eager body (scan_graph.EAGER)
    against a cache's first call, its capture and a replay, bit for bit;
    then, for SCAN_TIMED_SIDES at k = 10, host ms per scan (a synchronize
    on both sides), the host's launches and the device's kernels per scan,
    device-busy ms and idle share (utils/profiling.profiled), eager and
    replayed."""
    import torch

    from anime_recommendations_tpu_torch.ops import scan_graph
    from anime_recommendations_tpu_torch.ops.topk import _dispatch_topk

    out = {"cases": 0, "timed": {}, "graphs": {}}
    t0 = time.perf_counter()
    for side in SCAN_GRAPH_SIDES:
        graphs = scan_graph.ScanGraphs()
        for q in SCAN_GRAPH_Q:
            for k in SCAN_GRAPH_K:
                args = _scan_args(t, side, q, rng)
                want = _dispatch_topk(*args, k=k, graphs=scan_graph.EAGER, **kw)
                for call in range(3):    # eager in the cache, the capture, a replay
                    got = _dispatch_topk(*args, k=k, graphs=graphs, **kw)
                    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                        raise AssertionError(f"[phase 14] {label} {side} q{q} k{k}: call "
                                             f"{call} differs from the eager body")
                if got[0].shape != (q, k) or not bool((got[1] >= -1).all()):
                    raise AssertionError(f"[phase 14] {label} {side} q{q} k{k}: bad result")
                out["cases"] += 1
                if side in SCAN_TIMED_SIDES and k == 10:
                    eager = functools.partial(_dispatch_topk, *args, k=k,
                                              graphs=scan_graph.EAGER, **kw)
                    replay = functools.partial(_dispatch_topk, *args, k=k, graphs=graphs, **kw)
                    row = {f"host_ms_{m}": v for m, v in
                           _host_ms({"eager": eager, "replay": replay}, SCAN_TIMED_RUNS).items()}
                    reps = (SCAN_HEAVY_REPS if row["host_ms_eager"] > SCAN_HEAVY_MS
                            else SCAN_TIMED_RUNS)
                    for mode, fn in (("eager", eager), ("replay", replay)):
                        p = _profiled(fn, reps=reps)
                        row[mode] = {key: p[key] for key in (
                            "wall_ms", "device_ms", "idle_share", "host_launches",
                            "device_ops", "records_lost")}
                    out["timed"][f"{side}_q{q}"] = row
        expected = len(SCAN_GRAPH_Q) * len(SCAN_GRAPH_K)
        report = graphs.report()
        if (report["captures"], report["graphs"]) != (expected, expected) or \
                report["hits"] < expected:
            raise AssertionError(f"[phase 14] {label} {side}: {report}")
        out["graphs"][side] = {key: v for key, v in report.items() if key != "pool_mb"}
        out["graphs"][side]["pool_mb_max"] = max(report["pool_mb"])
        out["graphs"][side]["pool_mb_sum"] = sum(report["pool_mb"])
        graphs.release()
    out["seconds"] = time.perf_counter() - t0
    print(f"[phase 14] {label} ({card}): {json.dumps(out)}", flush=True)
    return out


def _http_requests(ctx, rng) -> list:
    """Mixed requests to every endpoint (distinct users, so the Engine's
    similar-users cache does not answer them), ~3 per endpoint."""
    vocab, catalog = ctx.vocab, ctx.catalog
    name_of = dict(zip(catalog.anime["anime_id"], catalog.anime["Name"]))
    users = [int(u) for u in rng.choice(vocab.user_ids, size=40, replace=False)]
    names = [str(name_of[int(a)]) for a in rng.choice(vocab.anime_ids, size=12, replace=False)]
    def ids(i):
        return ",".join(map(str, users[11 + 4 * i:15 + 4 * i]))

    return ([("similar_anime", dict(name=n, k=10)) for n in names[:3]]
            + [("similar_users", dict(user_id=u, k=10)) for u in users[:3]]
            + [("user_prefs", dict(user_id=u)) for u in users[3:5]]
            + [("user_recs", dict(user_id=u, k=10)) for u in users[5:8]]
            + [("model_recs", dict(user_id=u, k=10)) for u in users[8:11]]
            + [("similar_anime_batch", dict(names="|".join(names[3 + 3 * i:6 + 3 * i]), k=10))
               for i in range(3)]
            + [("model_recs_batch", dict(user_ids=ids(i), k=10)) for i in range(3)]
            + [("similar_users_batch", dict(user_ids=ids(3 + i), k=10)) for i in range(3)])


def _fetch(server, endpoint, params):
    url = (f"http://127.0.0.1:{server.server_address[1]}/{endpoint}?"
           f"{urllib.parse.urlencode(params)}")
    with urllib.request.urlopen(url, timeout=120) as resp:
        return json.loads(resp.read())


def _latency_requests(ctx, endpoint: str, rng, n: int) -> list:
    """n requests to one endpoint, each for other users or titles."""
    vocab, catalog = ctx.vocab, ctx.catalog
    users = [int(u) for u in rng.choice(vocab.user_ids, size=8 * n, replace=False)]
    titles = catalog.anime["Name"].astype(str).unique()
    names = [str(x) for x in rng.choice(titles, size=8 * n)]
    one = {"similar_anime": lambda i: dict(name=names[i], k=10),
           "similar_users": lambda i: dict(user_id=users[i], k=10),
           "user_prefs": lambda i: dict(user_id=users[i]),
           "user_recs": lambda i: dict(user_id=users[i], k=10),
           "model_recs": lambda i: dict(user_id=users[i], k=10),
           "similar_anime_batch": lambda i: dict(names="|".join(names[8 * i:8 * i + 8]), k=10),
           "model_recs_batch": lambda i: dict(
               user_ids=",".join(map(str, users[8 * i:8 * i + 8])), k=10),
           "similar_users_batch": lambda i: dict(
               user_ids=",".join(map(str, users[8 * i:8 * i + 8])), k=10)}[endpoint]
    return [one(i) for i in range(n)]


def _scan_graph_http(card: str) -> dict:
    """A fresh f32 context's HTTP server answering 8 threads of mixed
    requests while its first captures happen, against an eager context's
    answers (RecContext.scan_graphs = ScanGraphs(0)) on the same store; then
    each endpoint's latency through both servers, HTTP_SAMPLES requests
    each, taken in turns."""
    import torch

    from anime_recommendations_tpu_torch.config import Config
    from anime_recommendations_tpu_torch.ops import scan_graph
    from anime_recommendations_tpu_torch.pipeline.runner import context_from_store, store_root
    from anime_recommendations_tpu_torch.serve.api import make_server

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config()
        _write_store(store_root(cfg, tmp))
        eager_ctx = context_from_store(cfg, tmp, device="cuda")
        eager_ctx.scan_graphs = scan_graph.ScanGraphs(0)
        ctx = context_from_store(cfg, tmp, device="cuda")
        servers = {"eager": make_server(eager_ctx, cfg, host="127.0.0.1", port=0),
                   "captured": make_server(ctx, cfg, host="127.0.0.1", port=0)}
        threads = [threading.Thread(target=s.serve_forever, daemon=True)
                   for s in servers.values()]
        for th in threads:
            th.start()
        try:
            requests = _http_requests(ctx, np.random.default_rng(SEED + 14))
            want = [_fetch(servers["eager"], e, p) for e, p in requests]
            errors = []

            def client(c):
                for j in range(3 * len(requests)):
                    i = (5 * c + j) % len(requests)
                    try:
                        got = _fetch(servers["captured"], *requests[i])
                    except Exception as e:  # reported below with its request
                        errors.append((requests[i], repr(e)))
                        continue
                    if got != want[i]:
                        errors.append((requests[i], "differs from the eager answer"))

            t0 = time.perf_counter()
            with ThreadPoolExecutor(HTTP_THREADS) as pool:
                list(pool.map(client, range(HTTP_THREADS)))
            out["concurrent"] = {"requests": 3 * len(requests) * HTTP_THREADS,
                                 "seconds": time.perf_counter() - t0,
                                 "graphs": ctx.scan_graphs.report()}
            out["concurrent"]["graphs"].pop("pool_mb")
            if errors:
                raise AssertionError(f"[phase 14] concurrent requests: {errors[:5]}")
            if not ctx.scan_graphs.captures or not ctx.scan_graphs.hits:
                raise AssertionError(f"[phase 14] the concurrent requests captured nothing: "
                                     f"{ctx.scan_graphs.report()}")
            print(f"[phase 14] {HTTP_THREADS} threads x {3 * len(requests)} mixed requests "
                  f"during the first captures equal the eager answers ({card}): "
                  f"{json.dumps(out['concurrent'])}", flush=True)
            rng = np.random.default_rng(SEED + 15)
            latency = {}
            for endpoint in ("similar_anime", "similar_users", "user_prefs", "user_recs",
                             "model_recs", "similar_anime_batch", "model_recs_batch",
                             "similar_users_batch"):
                params = _latency_requests(ctx, endpoint, rng, HTTP_SAMPLES)
                times = {"eager": [], "captured": []}
                hits = ctx.scan_graphs.hits
                for i, p in enumerate(params):
                    order = ("eager", "captured") if i % 2 else ("captured", "eager")
                    for mode in order:
                        t0 = time.perf_counter()
                        _fetch(servers[mode], endpoint, p)
                        times[mode].append((time.perf_counter() - t0) * 1e3)
                latency[endpoint] = {mode: {"median_ms": float(np.median(ts)),
                                            "p90_ms": float(np.percentile(ts, 90))}
                                     for mode, ts in times.items()}
                latency[endpoint]["replayed_share"] = (ctx.scan_graphs.hits - hits) / HTTP_SAMPLES
                print(f"[phase 14] HTTP {endpoint} ({card}): {json.dumps(latency[endpoint])}",
                      flush=True)
            out["latency"] = latency
            out["graphs_held"] = len(ctx.scan_graphs)
        finally:
            for s, th in zip(servers.values(), threads):
                s.shutdown()
                s.server_close()
                th.join(timeout=30)
            ctx.release_graphs()
        del ctx, eager_ctx
        torch.cuda.empty_cache()
    return out


def phase_scan_graph(card: str) -> dict:
    """Phase 14: one retrieval request as one CUDA graph replay, at full
    width, every flavour (module docstring)."""
    import torch

    out = {"card": card, "flavours": {}}
    rng = np.random.default_rng(SEED)
    built = {}
    for label, (dtype, ann, kw) in SCAN_GRAPH_FLAVOURS.items():
        if (dtype, ann) not in built:
            built.clear()    # one set of tables on the card at a time
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            built[(dtype, ann)] = _scan_tables(dtype, ann)
            print(f"[phase 14] tables {dtype} ann={ann} built in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        out["flavours"][label] = _scan_flavour(card, label, built[(dtype, ann)], kw, rng)
    built.clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["http"] = _scan_graph_http(card)
    print(f"[phase 14] HTTP part: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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


ZIPF_SEED, ZIPF_RATINGS = 5, 2_000_000


@functools.cache
def _zipf_ratings():
    """bench.py:570-692's trained-table data, drawn in its order from
    np.random.default_rng(5) by the bench module's zipf_teacher: latent
    factors [91,641 | 17,560, 16], then 2,000,000 ratings of user
    min(pareto(1.1) * 40, 91,640) and anime min(pareto(1.05) * 15, 17,559)
    (popular rows at low ids), rated sigmoid(3 <u, a> + N(0, 0.35))."""
    from anime_recommendations_tpu_torch.bench import zipf_teacher

    teacher = zipf_teacher(np.random.default_rng(ZIPF_SEED), N_USERS, N_ANIME, ZIPF_RATINGS)
    return teacher.users, teacher.anime, teacher.ratings


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


# ---- phase 4b ------------------------------------------------------------------

# f32 operations per element of a dense Adam update (csrc/dense_adam.cu): the
# two moments (7) and the parameter (7).
DENSE_ADAM_OPS = 14
DENSE_ADAM_STEPS = (1, 2, 700)


def _dense_adam_case(card, name, shapes, seed) -> dict:
    """dense_adam_ on tensors of ``shapes`` (one launch) against its plain
    version on the card, three steps from one state: p, mu and nu bit for
    bit. Then the kernel's device time (torch.profiler, 20 calls after
    warm-up), the plain chain's, the CUDA-event medians, and 28 bytes an
    element against 3.35 TB/s."""
    import torch

    from anime_recommendations_tpu_torch.ops import dense_adam, fused_adam

    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    t = lambda shape, scale: torch.from_numpy(
        np.asarray(rng.standard_normal(shape) * scale, np.float32)).to(dev)
    quads = [(t(sh, 0.05), t(sh, 1e-3), t(sh, 1e-4), t(sh, 1e-4).square()) for sh in shapes]
    plain = [tuple(x.clone() for x in q) for q in quads]
    eps = dense_adam.KERAS_ADAM_EPS
    for step in DENSE_ADAM_STEPS:
        scal = fused_adam.scalar_row(step, ADAM_LR, dev)
        _, launches = _launched(lambda: dense_adam.dense_adam_(*zip(*quads), scal))
        if launches != {"dense_adam": 1}:
            raise AssertionError(f"{name}: dense_adam_ launched {launches}")
        dense_adam._dense_adam_plain(*zip(*plain), scal, eps)
    torch.cuda.synchronize()
    for i, (q, r) in enumerate(zip(quads, plain)):
        for label, a, c in zip(("p", "g", "mu", "nu"), q, r):
            if not torch.equal(a, c):
                raise AssertionError(f"{name}: {label} of tensor {i} differs from the plain "
                                     f"version on {int((a != c).sum())} elements")
    scal = fused_adam.scalar_row(DENSE_ADAM_STEPS[-1] + 1, ADAM_LR, dev)
    elements = sum(q[0].numel() for q in quads)
    moved = 28 * elements   # p, g, mu and nu read, p, mu and nu written: f32
    row = dict(card=card, case=name, tensors=len(quads), elements=elements, bit_equal=True,
               launches=1, **_timing(lambda: dense_adam._dense_adam_cuda(*zip(*quads), scal, eps),
                                     lambda: dense_adam._dense_adam_plain(*zip(*plain), scal, eps),
                                     "dense_adam_kernel"))
    row["bytes_moved"] = moved
    row["hbm_share"] = moved / (row["ms"] * 1e-3) / HBM_BYTES_PER_S
    row |= _bound(moved, DENSE_ADAM_OPS * elements)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print("[phase 4b] " + json.dumps(row), flush=True)
    return row


def phase_dense_adam(card: str) -> list[dict]:
    """The dense Adam kernel at the adam cell's shapes (the 91,641 x 128 and
    17,560 x 128 tables and the four head scalars: trainer.dense_step's one
    launch) and at the head's alone (lazy._head_adam's, in the fused and
    lazy steps)."""
    return [_dense_adam_case(card, "adam_step", [(N_USERS, D), (N_ANIME, D)] + [()] * 4,
                             SEED + 40),
            _dense_adam_case(card, "head_scalars", [()] * 4, SEED + 41)]


# ---- phase 4c ------------------------------------------------------------------

# The KDD-Cup'11 lazy cell's step (portbench/configs/yahoomusic-kddcup11.json):
# 1,000,990 user and 624,961 item rows of D, 10,000 ids each a step, users
# uniform and items Zipf-0.8 over a seeded permutation of the rows.
LAZY_ROWS = (1_000_990, 624_961)
LAZY_BATCHES = 8     # id sets the timed calls cycle through: ~220 MB of rows, past the 50 MB L2
LAZY_LR, LAZY_L2 = 1e-3, 1e-4
LAZY_ADAM_OPS = 16   # f32 operations an element of a touched row: the sum's add, the update's 15


def _lazy_batch(rng, perm, dev):
    """One step's ids and gradient rows for both tables, on the card."""
    import torch

    p = np.arange(1, LAZY_ROWS[1] + 1, dtype=np.float64) ** -0.8
    users = rng.integers(0, LAZY_ROWS[0], BATCH)
    ids = (users, perm[rng.choice(LAZY_ROWS[1], BATCH, p=p / p.sum())])
    return [(torch.from_numpy(i.astype(np.int32)).to(dev),
             torch.from_numpy((rng.standard_normal((BATCH, D)) * 1e-2).astype(np.float32)).to(dev))
            for i in ids]


def phase_lazy_adam(card: str) -> dict:
    """The row-sparse Adam kernel (csrc/lazy_adam.cu; it replaces no Pallas
    kernel) at the lazy cell's shapes, both tables in one launch, against its
    plain version, the torch chain, on the card: one step from one state,
    rows the batch hits once bit for bit, every row within 1e-5 of each
    tensor's largest entry (the chain's index_add_ sums in atomics' order);
    the kernel again from the same state bit for bit itself. Then, cycling
    through LAZY_BATCHES steps' ids (the touched rows out of L2), the
    kernel's device time, the whole call's (the id sort included) and the
    chain's (torch.profiler, 20 calls after warm-up), both CUDA-event
    medians, and the bytes a step needs (the gradient rows, the sorted keys
    and order, W, mu and nu of each touched row read and written) against
    3.35 TB/s."""
    import torch

    from anime_recommendations_tpu_torch.ops import fused_adam, lazy_adam

    rng = np.random.default_rng(SEED + 42)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    randn = lambda n, s: torch.randn(n, D, generator=gen, device=dev) * s
    state = [(randn(n, 0.05), randn(n, 1e-3), randn(n, 1e-3).square()) for n in LAZY_ROWS]
    perm = rng.permutation(LAZY_ROWS[1])
    batches = [_lazy_batch(rng, perm, dev) for _ in range(LAZY_BATCHES)]
    tables = lambda st, b: [lazy_adam.LazyTable(*t, ids, g) for t, (ids, g) in zip(st, b)]
    scal = fused_adam.scalar_row(3, LAZY_LR, dev)
    plain = [tuple(x.clone() for x in t) for t in state]
    ours = [tuple(x.clone() for x in t) for t in state]
    _, launches = _launched(lambda: lazy_adam.lazy_adam_(tables(ours, batches[0]), scal, LAZY_L2))
    if launches != {"lazy_adam": 1}:
        raise AssertionError(f"lazy_adam_ launched {launches}")
    for t in tables(plain, batches[0]):
        lazy_adam._lazy_row_adam_plain(*t[:5], scal, LAZY_L2)
    again = [tuple(x.clone() for x in t) for t in state]
    lazy_adam.lazy_adam_(tables(again, batches[0]), scal, LAZY_L2)
    torch.cuda.synchronize()
    row = dict(card=card, case="lazy_cell_step", rows=list(LAZY_ROWS), batch=BATCH, d=D,
               launches=1)
    for name, o, p, a, (ids, _) in zip(("users", "items"), ours, plain, again, batches[0]):
        counts = torch.bincount(ids.long(), minlength=o[0].shape[0])
        once = counts == 1
        for label, x, y, z in zip(("w", "mu", "nu"), o, p, a):
            if not torch.equal(x, z):
                raise AssertionError(f"lazy_adam {name}: {label} differs between two launches")
            if not torch.equal(x[once], y[once]):
                raise AssertionError(f"lazy_adam {name}: {label} of rows hit once differs from "
                                     f"the chain on {int((x[once] != y[once]).sum())} elements")
            err = float((x - y).abs().max())
            if err > 1e-5 * float(y.abs().max()):
                raise AssertionError(f"lazy_adam {name}: {label} {err} from the chain")
            row[f"{name}_{label}_max_abs_err"] = err
        row[f"{name}_hottest_run"] = int(counts.max())
    del plain, again
    # The timed calls update ``state`` itself, cycling through the batches.
    step = iter(range(1 << 30))
    kernel = lambda: lazy_adam.lazy_adam_(tables(state, batches[next(step) % LAZY_BATCHES]),
                                          scal, LAZY_L2)

    def chain():
        for t in tables(state, batches[next(step) % LAZY_BATCHES]):
            lazy_adam._lazy_row_adam_plain(*t[:5], scal, LAZY_L2)

    prof, plain_prof = _profiled(kernel, match="lazy_adam_kernel"), _profiled(chain)
    row |= dict(ms=prof["match_ms"], call_device_ms=prof["device_ms"],
                call_by_kernel_ms=prof["by_kernel"], call_device_ops=prof["device_ops"],
                sessions=prof["sessions"], plain_ms=plain_prof["device_ms"],
                plain_device_ops=plain_prof["device_ops"],
                plain_records_lost=plain_prof["records_lost"],
                event_ms=_median_ms(kernel), plain_event_ms=_median_ms(chain))
    unique = np.mean([sum(len(torch.unique(ids)) for ids, _ in b) for b in batches])
    positions = BATCH * len(LAZY_ROWS)
    moved = positions * (D * 4 + 4 + 8) + unique * 24 * D
    row |= dict(touched_rows=unique, bytes_moved=moved,
                hbm_share=moved / (row["ms"] * 1e-3) / HBM_BYTES_PER_S,
                **_bound(moved, LAZY_ADAM_OPS * unique * D))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print("[phase 4c] " + json.dumps(row), flush=True)
    return row


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
            # One dense Adam launch a step: adam's six parameters, or the
            # other optimizers' four head scalars.
            dense = _kernels.launches["dense_adam"] - before.get("dense_adam", 0)
            if dense != steps:
                raise AssertionError(f"{optimizer}: {dense} dense_adam launches for {steps} "
                                     f"steps, expected one a step")
            # One lazy Adam launch a lazy_adam step (both tables), none elsewhere.
            lazy = _kernels.launches["lazy_adam"] - before.get("lazy_adam", 0)
            if lazy != (steps if optimizer == "lazy_adam" else 0):
                raise AssertionError(f"{optimizer}: {lazy} lazy_adam launches for {steps} "
                                     f"steps")
            out["launches"][optimizer] = launched["fused_adam"]
            out.setdefault("dense_adam_launches", {})[optimizer] = dense
            out.setdefault("lazy_adam_launches", {})[optimizer] = lazy
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


# ---- phase 13 ------------------------------------------------------------------

GRAPH_LRS = (1e-5, 2e-5)   # phase 13's two epochs: a change of lr between them
GRAPH_GROUPS = {
    "tables": ("user_emb", "anime_emb"),
    "moments": tuple(f"{m}.{k}" for m in ("mu", "nu") for k in ("user_emb", "anime_emb")),
    "head_scalars": tuple(f"{m}{k}" for m in ("", "mu.", "nu.")
                          for k in ("dense_w", "bn_gamma", "bn_beta")),
    "bn_stats": ("moving_var",),
    # dense_b's gradient is rounding noise (BatchNorm cancels the bias), so
    # Adam walks it by up to lr a step and moving_mean follows it: held to
    # bit equality where the eager runs are, else printed and not bounded
    # (tests/test_torch_train.py does not compare dense_b either).
    "noise_walk": tuple(f"{m}dense_b" for m in ("", "mu.", "nu.")) + ("moving_mean",),
}


def _graph_run(optimizer: str, epoch_fn, data) -> dict:
    """Two epochs of ``epoch_fn`` (dl.train_epoch or dl.eager_train_epoch)
    from phase 13's initial state and shuffle generators: the state, the
    losses and mses, each epoch's seconds, the peak memory above the start,
    and the launches of K1 and its first pass."""
    import torch

    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.train import trainer as tr

    state = _fresh_state(optimizer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = dict(_kernels.launches)
    hist, seconds = {"losses": [], "mses": []}, []
    for epoch, lr in enumerate(GRAPH_LRS):
        (state, losses, mses, _), sec = _host_timed(lambda: epoch_fn(
            state, data, torch.Generator().manual_seed(SEED + epoch), lr, BATCH, 1e-4,
            optimizer=optimizer))
        hist["losses"].append(losses.cpu().numpy())
        hist["mses"].append(mses.cpu().numpy())
        seconds.append(sec)
        if not (np.isfinite(hist["losses"][-1]).all() and np.isfinite(hist["mses"][-1]).all()):
            raise AssertionError(f"{optimizer} ({epoch_fn.__name__}): non-finite loss or mse")
    return dict(state=state, arrays=tr.train_state_to_numpy(state), seconds=seconds,
                hist={k: np.concatenate(v) for k, v in hist.items()},
                peak_bytes=torch.cuda.max_memory_allocated() - base,
                launches={k: _kernels.launches[k] - before.get(k, 0)
                          for k in ("fused_adam_tiles", "fused_adam", "fused_adam_gather")})


def _graph_gaps(a: dict, b: dict) -> dict:
    """Largest absolute gap between two runs per group, and whether every
    tensor of the group is bit-equal; the Adam counts' difference."""
    out = {}
    for group, keys in (("losses", ("losses",)), ("mses", ("mses",)), *GRAPH_GROUPS.items()):
        pairs = [(a["hist"][k], b["hist"][k]) if k in a["hist"]
                 else (a["arrays"][k], b["arrays"][k]) for k in keys]
        out[group] = {"max_abs": max(float(np.max(np.abs(x - y))) for x, y in pairs),
                      "rel": max(float(np.max(np.abs(x - y))) / max(float(np.max(np.abs(y))), 1e-30)
                                 for x, y in pairs),
                      "bit_equal": all(np.array_equal(x, y) for x, y in pairs)}
    out["count"] = int(a["arrays"]["count"]) - int(b["arrays"]["count"])
    return out


def phase_graph(card: str) -> dict:
    """The captured epoch at full width, per optimizer: two eager epochs,
    two more from the same state and generators, and two captured ones
    (the first captures the graph); their gaps, times, device profiles,
    capture costs, memory and launches."""
    import torch

    from anime_recommendations_tpu_torch.ops import _kernels, fused_adam
    from anime_recommendations_tpu_torch.train import device_loop as dl

    train, _ = _train_split()
    data = dl.stage(train, BATCH, seed=SEED, device=DEVICE)
    steps = data.n // BATCH
    window = dl.DeviceData(*(x[:10 * BATCH] for x in data))
    out = {"card": card, "steps": steps, "lrs": list(GRAPH_LRS)}
    # The host's cost of a step row for callers with host numbers (one
    # upload a call) and of an epoch's scalar table.
    row_s = _host_timed(lambda: [fused_adam.scalar_row(t, 1e-5, DEVICE) for t in range(1, 1001)])[1]
    table_s = _host_timed(lambda: dl.scalar_table(0, steps, 1e-5))[1]
    out["scalar_row_us"], out["scalar_table_ms"] = row_s * 1e3, table_s * 1e3
    print(f"[phase 13] host cost: a step row uploaded per call {out['scalar_row_us']:.2f} us; "
          f"an epoch's scalar table ({steps} rows) {out['scalar_table_ms']:.3f} ms ({card})",
          flush=True)
    for optimizer in OPTIMIZERS:
        warm0 = sum(_kernels.warmup_launches.values())
        eager = _graph_run(optimizer, dl.eager_train_epoch, data)
        again = _graph_run(optimizer, dl.eager_train_epoch, data)
        captured = _graph_run(optimizer, dl.train_epoch, data)
        graph = dl.train_graph(captured["state"], data, BATCH, 1e-4, optimizer=optimizer)
        row = {"optimizer": optimizer,
               "captured_vs_eager": _graph_gaps(captured, eager),
               "eager_vs_eager": _graph_gaps(again, eager)}
        eager_equal = all(g["bit_equal"] for k, g in row["eager_vs_eager"].items()
                          if k != "count")
        for k, g in row["captured_vs_eager"].items():
            if k == "count":
                if g != 0 or row["eager_vs_eager"]["count"] != 0:
                    raise AssertionError(f"{optimizer}: the Adam counts differ")
                continue
            if optimizer in FUSED or eager_equal:
                if not g["bit_equal"]:
                    raise AssertionError(f"{optimizer}: the captured epoch's {k} differ from the "
                                         f"eager epoch's: {g}")
            elif k != "noise_walk" and g["rel"] > 1e-5:
                raise AssertionError(f"{optimizer}: the captured epoch's {k} differ from the "
                                     f"eager epoch's by {g['rel']} of their scale")
        if optimizer in FUSED and not eager_equal:
            raise AssertionError(f"{optimizer}: two eager runs differ: {row['eager_vs_eager']}")
        want = 2 * steps * len(GRAPH_LRS) if optimizer in FUSED else 0
        for label, run in (("eager", eager), ("captured", captured)):
            if run["launches"] != {"fused_adam_tiles": want, "fused_adam": want,
                                   "fused_adam_gather": 0}:
                raise AssertionError(f"{optimizer} {label}: launches {run['launches']}, "
                                     f"expected {want} of K1 and its first pass")
        if graph.replays != len(GRAPH_LRS) or graph.launches.get("fused_adam", 0) != want // 2:
            raise AssertionError(f"{optimizer}: {graph.replays} replays, "
                                 f"{dict(graph.launches)} launches each")
        row["graph"] = {"replays_per_epoch": graph.replays / len(GRAPH_LRS),
                        "k1_per_replay": graph.launches.get("fused_adam", 0),
                        "first_pass_per_replay": graph.launches.get("fused_adam_tiles", 0),
                        "warmup_launches": sum(_kernels.warmup_launches.values()) - warm0,
                        **{f"{k}_s": v for k, v in graph.seconds.items()}}
        for label, run, fn in (("eager", eager, dl.eager_train_epoch),
                               ("captured", captured, dl.train_epoch)):
            ms = run["seconds"][-1] * 1e3 / steps
            state = run["state"]
            row[label] = dict(ms_per_step=ms, examples_per_sec=len(train) / run["seconds"][-1],
                              first_epoch_s=run["seconds"][0],
                              peak_bytes=run["peak_bytes"], launches=run["launches"],
                              **_step_profile(lambda: fn(state, window, None, 1e-5, BATCH, 1e-4,
                                                         shuffle=False, optimizer=optimizer),
                                              10, ms))
            row[label]["profiled_step"].pop("by_kernel")
        out[optimizer] = row
        print(f"[phase 13] {optimizer} ({card}): {json.dumps(row)}", flush=True)
    dl.release_graphs()
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


def _routed_trainer(optimizer: str, capacity=None, routing: str = "alltoall",
                    shard_anime: bool = False):
    from anime_recommendations_tpu_torch.parallel.trainer import ShardedTrainer

    return ShardedTrainer(batch_size=BATCH, optimizer=optimizer, capacity=capacity, seed=SEED,
                          verbose=False, device=DEVICE, device_loop=True, routing=routing,
                          shard_anime=shard_anime)


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


ROUTED_TIMED_STEPS = 60   # the depth of 7b's and 10a's epochs: a fifth of an epoch
ROUTED_LRS = (1e-5, 2e-5)  # their two epochs: a change of lr between them
HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__")


@contextlib.contextmanager
def _host_reads():
    """Counts the reads of a tensor on the host (the Tensor methods of
    HOST_READS) made while it is open; yields the counter."""
    import torch

    counter = {"reads": 0}
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def counted(fn):
        def wrapped(*args, **kwargs):
            counter["reads"] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name, fn in saved.items():
        setattr(torch.Tensor, name, counted(fn))
    try:
        yield counter
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _routed_run(case: tuple, captured: bool, data, holdout) -> dict:
    """Two epochs (ROUTED_LRS, each with its granule permutation from SEED +
    epoch) of a ShardedTrainer on ``data`` through its graphs
    (``captured``) or its eager loops, then an evaluation of ``holdout``:
    the state, the losses, mses and validation pair, each epoch's seconds
    and host reads, the peak memory above the start, K1's launches, and the
    graphs' replays, capture seconds and memory pools."""
    import torch

    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.train import device_loop as dl
    from anime_recommendations_tpu_torch.train import trainer as tr

    _, vocab, _, _ = _dataset()
    trainer = _routed_trainer(*case)
    state = trainer._init_state(torch.Generator().manual_seed(SEED), vocab.n_users, vocab.n_anime)
    epoch_fn = trainer.train_epoch if captured else trainer.eager_train_epoch
    eval_fn = trainer.eval_epoch if captured else trainer.eager_eval_epoch
    dl.release_graphs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = dict(_kernels.launches)
    hist, seconds, reads = {"losses": [], "mses": []}, [], []
    for epoch, lr in enumerate(ROUTED_LRS):
        perm = dl.granule_permutation(data.n, torch.Generator().manual_seed(SEED + epoch))
        with _host_reads() as counter:
            (state, losses, mses, _), sec = _host_timed(
                lambda: epoch_fn(state, data, BATCH, lr, perm))
        reads.append(counter["reads"])
        hist["losses"].append(losses.cpu().numpy())
        hist["mses"].append(mses.cpu().numpy())
        seconds.append(sec)
        if not (np.isfinite(hist["losses"][-1]).all() and np.isfinite(hist["mses"][-1]).all()):
            raise AssertionError(f"routed {case}: non-finite loss or mse")
    val = torch.stack(eval_fn(state.model, holdout, BATCH)).cpu().numpy()
    # A graph's private pool keeps its segments while the graph lives: their
    # size is the pool's footprint, its peak rounded up to segments.
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg["segment_pool_id"])
        pools[pool] = pools.get(pool, 0) + seg["total_size"]
    graphs = {}
    for key, graph in dl._GRAPHS.items():
        g = graphs.setdefault(key[0], {"graphs": 0, "replays": 0, "capture_s": 0.0,
                                       "instantiate_s": 0.0, "warm_up_s": 0.0, "pool_mb": 0.0})
        g["graphs"] += 1
        g["replays"] += graph.replays
        g["pool_mb"] += pools.get(tuple(graph.graph.pool()), 0) / 1e6
        for k, v in graph.seconds.items():
            g[f"{k}_s"] += v
    return dict(state=state, trainer=trainer, arrays=tr.train_state_to_numpy(state),
                hist={**{k: np.concatenate(v) for k, v in hist.items()}, "val": val},
                seconds=seconds, host_reads=reads, graphs=graphs,
                peak_bytes=torch.cuda.max_memory_allocated() - base,
                launches={k: _kernels.launches[k] - before.get(k, 0)
                          for k in ("fused_adam_tiles", "fused_adam", "fused_adam_dense")})


def _routed_graph_case(card: str, label: str, case: tuple) -> dict:
    """The routed or psum epoch, eager and captured, from one state and one
    shuffle (_routed_run, ROUTED_TIMED_STEPS batches an epoch): the captured
    epochs bit-equal to the eager ones (lazy_adam within 1e-5 of each
    tensor's scale, but for the noise walk of dense_b), one replay of the
    epoch's graph per epoch, K1's launches equal; each one's ms per step
    (the second epoch), 10 profiled steps (device-busy ms, idle shares),
    peak memory, host reads per epoch, and the graphs' capture seconds."""
    import torch

    from anime_recommendations_tpu_torch.train import device_loop as dl

    optimizer, capacity = case[0], case[1]
    train, holdout = _train_split()
    data = dl.granule_shuffle(dl.stage(train, BATCH, seed=SEED, device=DEVICE),
                              torch.Generator().manual_seed(SEED))
    steps = ROUTED_TIMED_STEPS
    data = dl.DeviceData(*(x[:steps * BATCH] for x in data))
    window = dl.DeviceData(*(x[:10 * BATCH] for x in data))
    held = dl.stage(holdout, BATCH, device=DEVICE)
    eager = _routed_run(case, False, data, held)
    captured = _routed_run(case, True, data, held)
    row = {"case": label, "card": card, "steps_per_epoch": steps,
           "captured_vs_eager": _graph_gaps(captured, eager)}
    val_equal = np.array_equal(captured["hist"]["val"], eager["hist"]["val"])
    val_rel = float(np.max(np.abs(captured["hist"]["val"] - eager["hist"]["val"])
                           / np.abs(eager["hist"]["val"])))
    row["captured_vs_eager"]["val"] = {"rel": val_rel, "bit_equal": val_equal}
    for k, g in row["captured_vs_eager"].items():
        if k == "count":
            if g != 0:
                raise AssertionError(f"{label}: the Adam counts differ")
        elif optimizer != "lazy_adam":
            if not g["bit_equal"]:
                raise AssertionError(f"{label}: the captured epoch's {k} differ from the eager "
                                     f"epoch's: {g}")
        elif k != "noise_walk" and g["rel"] > 1e-5:
            raise AssertionError(f"{label}: the captured epoch's {k} differ from the eager "
                                 f"epoch's by {g['rel']} of their scale")
    want = {"fused_adam_tiles": 0, "fused_adam": 0, "fused_adam_dense": 0}
    if optimizer in FUSED:
        want["fused_adam" if capacity is None else "fused_adam_dense"] = 2 * steps * len(ROUTED_LRS)
        want["fused_adam_tiles"] = 2 * steps * len(ROUTED_LRS)
    for name, run in (("eager", eager), ("captured", captured)):
        if run["launches"] != want:
            raise AssertionError(f"{label} {name}: launches {run['launches']}, expected {want}")
    epochs = len(ROUTED_LRS)
    graphs = captured["graphs"]
    if graphs.get("sharded_epoch", {}).get("replays") != epochs or eager["graphs"]:
        raise AssertionError(f"{label}: graphs {graphs} over {epochs} epochs (eager: "
                             f"{eager['graphs']}); expected one epoch replay per epoch")
    row["graphs"] = graphs
    row["replays_per_epoch"] = {k: v["replays"] / epochs for k, v in graphs.items()
                                if k != "sharded_eval"}
    row["rounds"] = captured["trainer"]._rounds
    for name, run in (("eager", eager), ("captured", captured)):
        trainer, state = run["trainer"], run["state"]
        fn = trainer.train_epoch if name == "captured" else trainer.eager_train_epoch
        ms = run["seconds"][-1] * 1e3 / steps
        row[name] = dict(ms_per_step=ms, examples_per_sec=float(data.weights.sum()) / run["seconds"][-1],
                         first_epoch_s=run["seconds"][0], host_reads_per_epoch=run["host_reads"],
                         peak_bytes=run["peak_bytes"], launches=run["launches"],
                         **_step_profile(lambda: fn(state, window, BATCH, 1e-5), 10, ms))
        by_kernel = row[name]["profiled_step"].pop("by_kernel")
        row[name]["top_kernels_ms"] = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])
    dl.release_graphs()
    phase = "10a" if case[2:3] == ("psum",) else "7b"
    print(f"[phase {phase}] {label} eager vs captured ({card}): "
          f"{json.dumps(row)}", flush=True)
    return row


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
    # Each call: K1 (or its dense branch) and its first pass on both tables,
    # and the head's dense Adam.
    if launches != {"fused_adam_tiles": AGREE_STEPS * 4, "fused_adam": AGREE_STEPS * 2,
                    "fused_adam_dense": AGREE_STEPS * 2, "dense_adam": AGREE_STEPS * 2}:
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
        out["timed"][label] = _routed_graph_case(card, label, (optimizer, capacity))
        base = trained["timed"][optimizer]["ms_per_step"]
        print(f"[phase 7] routed {label}: ms/step eager "
              f"{out['timed'][label]['eager']['ms_per_step']:.3f}, captured "
              f"{out['timed'][label]['captured']['ms_per_step']:.3f}; one-device (phase 13) "
              f"{base:.3f} ({card})", flush=True)
    return out


# ---- phase 15 ------------------------------------------------------------------

STEP_GRAPH_STEPS = 20        # calls per run: the first eager, the second captured
STEP_PROFILED = 10           # calls under torch.profiler after them (and 3 warm-up)
# label -> the optimizer of its state (phase 13's initial state), by entry point:
# train_step, lazy_train_step, fused_train_step with f32 and bf16 moments,
# fused_train_step_pipelined without and with K5's gather.
STEP_GRAPH_CASES = {"adam": "adam", "lazy_adam": "lazy_adam", "fused_adam": "fused_adam",
                    "fused_adam_bf16m": "fused_adam_bf16m", "pipelined": "fused_adam",
                    "pipelined_kernel_gather": "fused_adam"}
# The routed and psum steps at world size 1: (optimizer, capacity, routing).
SHARDED_STEP_CASES = {"fused_adam": ("fused_adam", None, "alltoall"),
                      f"fused_adam@{CAPPED}": ("fused_adam", CAPPED, "alltoall"),
                      "psum_adam": ("adam", None, "psum")}
STEP_CALLS = STEP_GRAPH_STEPS + 3 + STEP_PROFILED   # a run's calls of its train step
STEP_KERNELS = ("fused_adam_tiles", "fused_adam", "fused_adam_dense", "fused_adam_gather",
                "fused_adam_copies")


@functools.cache
def _step_batches() -> list:
    """STEP_GRAPH_STEPS + 1 numpy batches of BATCH rows of phase 5's training
    split in stage(seed=SEED)'s host order: (users, anime, ratings, weights)."""
    train, _ = _train_split()
    n = (STEP_GRAPH_STEPS + 1) * BATCH
    order = np.random.default_rng(SEED).permutation(len(train))[:n]
    cols = (train.users[order].astype(np.int32), train.anime[order].astype(np.int32),
            train.ratings[order].astype(np.float32), np.ones(n, np.float32))
    return [tuple(c[i * BATCH:(i + 1) * BATCH] for c in cols)
            for i in range(STEP_GRAPH_STEPS + 1)]


@contextlib.contextmanager
def _step_cache(graphs):
    """Every step entry point takes ``graphs`` (a StepGraphs) while it is open."""
    from anime_recommendations_tpu_torch.train import step_graph

    saved = step_graph.graphs_for
    step_graph.graphs_for = lambda device: graphs
    try:
        yield
    finally:
        step_graph.graphs_for = saved


def _entry_call(label: str):
    """call(state, rows, cols, next_cols, lr) -> (state, rows, (loss, mse)):
    one call of the label's entry point; ``rows`` the pipelined steps'
    gathered rows, carried from call to call."""
    from anime_recommendations_tpu_torch.train import trainer as tr
    from anime_recommendations_tpu_torch.train.fused import (
        fused_train_step,
        fused_train_step_pipelined,
    )
    from anime_recommendations_tpu_torch.train.lazy import lazy_train_step

    def call(state, rows, cols, nxt, lr):
        if label == "adam":
            state, *out = tr.train_step(state, *cols, lr, 1e-4)
        elif label == "lazy_adam":
            state, *out = lazy_train_step(state, *cols, lr, 1e-4)
        elif label in FUSED:
            state, *out = fused_train_step(state, *cols, lr, 1e-4)
        else:
            state, *out = fused_train_step_pipelined(
                state, *rows, *cols, *nxt[:2], lr, 1e-4,
                kernel_gather=label == "pipelined_kernel_gather")
            rows = tuple(out[2:])
        return state, rows, tuple(out[:2])

    return call


def _timed_steps(call, state, rows, batches, graphs) -> dict:
    """STEP_GRAPH_STEPS calls through ``graphs`` (lr GRAPH_LRS in turn), the
    launch counters set to 0 before them and read after: the state, the
    losses and mses, ms per step over the calls from the third on (host
    clock between synchronizes), the launches, the host reads a step
    (_host_reads: the round counts at 512 slots), then STEP_PROFILED calls
    under torch.profiler (device-busy ms, idle share, host launches per
    step)."""
    import torch

    from anime_recommendations_tpu_torch.ops import _kernels

    hist = {"losses": [], "mses": []}
    with _step_cache(graphs):
        _kernels.launches.clear()
        with _host_reads() as reads:
            for i in range(STEP_GRAPH_STEPS):
                if i == 2:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                state, rows, (loss, mse) = call(state, rows, batches[i], batches[i + 1],
                                                GRAPH_LRS[i % 2])
                hist["losses"].append(loss)
                hist["mses"].append(mse)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (STEP_GRAPH_STEPS - 2)
        launches = {k: _kernels.launches[k] for k in STEP_KERNELS}
        hist = {k: torch.stack(v).cpu().numpy() for k, v in hist.items()}
        box = [state, rows]

        def one():
            box[0], box[1], _ = call(box[0], box[1], batches[0], batches[1], GRAPH_LRS[0])

        prof = _profiled(one, reps=STEP_PROFILED)
    if not (np.isfinite(hist["losses"]).all() and np.isfinite(hist["mses"]).all()):
        raise AssertionError("non-finite loss or mse")
    return dict(state=state, hist=hist, ms_per_step=ms, launches=launches,
                host_reads_per_step=reads["reads"] / STEP_GRAPH_STEPS,
                profile={k: prof[k] for k in ("wall_ms", "device_ms", "idle_share",
                                              "host_launches", "device_ops", "records_lost")})


def _check_replayed(label: str, eager: dict, captured: dict, graphs, lazy: bool,
                    captures: int, hits: int) -> tuple:
    """captured's losses, mses and state against eager's (_graph_gaps):
    bit-equal, or within 1e-5 of each tensor's scale (lazy: index_add_'s
    atomics), the head scalars of the largest of them, but for dense_b's
    noise walk; the launches equal; the cache's
    ``captures`` and ``hits`` (a replay per call of a signature from its
    second on). Returns the gaps and the cache's report."""
    gaps = _graph_gaps(captured, eager)
    # The head scalars (one value each) against the largest of them: bn_beta's
    # value is a sum of steps of either sign, so its own scale is no measure.
    heads = [[(captured["arrays"][f"{m}{k}"], eager["arrays"][f"{m}{k}"])
              for k in ("dense_w", "bn_gamma", "bn_beta")] for m in ("", "mu.", "nu.")]
    gaps["head_scalars"]["group_rel"] = max(
        max(float(np.abs(x - y).max()) for x, y in pairs)
        / max(max(float(np.abs(y).max()) for _, y in pairs), 1e-30) for pairs in heads)
    for k, g in gaps.items():
        if k == "count":
            if g != 0:
                raise AssertionError(f"[phase 15] {label}: the Adam counts differ")
        elif not lazy:
            if not g["bit_equal"]:
                raise AssertionError(f"[phase 15] {label}: the replayed {k} differ from the "
                                     f"eager steps': {g}")
        elif k != "noise_walk" and g.get("group_rel", g["rel"]) > 1e-5:
            raise AssertionError(f"[phase 15] {label}: the replayed {k} differ from the eager "
                                 f"steps' by {g['rel']} of their scale")
    if captured["launches"] != eager["launches"]:
        raise AssertionError(f"[phase 15] {label}: launches {captured['launches']}, eager "
                             f"{eager['launches']}")
    report = graphs.report()
    if (report["captures"], report["hits"]) != (captures, hits):
        raise AssertionError(f"[phase 15] {label}: {report}, expected {captures} captures and "
                             f"{hits} hits")
    return gaps, report


def _padded_round_keys(capacity, batches) -> list:
    """The rounds (users, anime) each of a run's train_step calls runs at
    one rank (ShardedTrainStep.make_plans: the largest counts so far; the
    profiled calls take batches[0]), or None where no plan is read."""
    from anime_recommendations_tpu_torch.parallel import routing as rt

    if capacity is None:
        return [None] * STEP_CALLS
    keys, most = [], (0, 0)
    for i in [*range(STEP_GRAPH_STEPS), *[0] * (STEP_CALLS - STEP_GRAPH_STEPS)]:
        own = tuple(rt.plan_stats(ids, 1, capacity)[2] for ids in batches[i][:2])
        most = tuple(max(a, b) for a, b in zip(most, own))
        keys.append(most)
    return keys


def _expected_cache(keys) -> tuple[int, int]:
    """(captures, hits) of a run whose calls take these signatures in turn
    (each one's calls contiguous): a signature's first call runs eagerly,
    its second captures, later ones replay."""
    counts = [len(list(g)) for _, g in itertools.groupby(keys)]
    return sum(c >= 2 for c in counts), sum(max(c - 2, 0) for c in counts)


def _state_arrays(state) -> dict:
    from anime_recommendations_tpu_torch.train import trainer as tr

    return tr.train_state_to_numpy(state)


def _step_row(label: str, card: str, eager: dict, captured: dict, gaps: dict,
              report: dict) -> dict:
    """A case's printed row; idle_share_timed is 1 - device-busy ms over
    the unprofiled ms per step (the profiler slows the host, so its own
    idle share overstates it)."""
    return {"case": label, "card": card, "steps": STEP_GRAPH_STEPS,
            "replayed_vs_eager": gaps, "launches": captured["launches"],
            "ms_per_step": {"eager": eager["ms_per_step"], "replayed": captured["ms_per_step"]},
            "idle_share_timed": {
                mode: 1 - run["profile"]["device_ms"] / run["ms_per_step"]
                for mode, run in (("eager", eager), ("replayed", captured))},
            "host_reads_per_step": {"eager": eager["host_reads_per_step"],
                                    "replayed": captured["host_reads_per_step"]},
            "profiled": {"eager": eager["profile"], "replayed": captured["profile"]},
            "graphs": {k: v for k, v in report.items() if k != "pool_mb"},
            "pool_mb": report["pool_mb"]}


def phase_step_graph(card: str) -> dict:
    """Phase 15: each one-device entry point, STEP_GRAPH_STEPS calls eagerly
    (step_graph.EAGER) and through a step-graph cache from phase 13's
    initial state on the same batches: bit-equal (lazy_adam within 1e-5 of
    scale), the path's kernels launched (K1 and its first pass, K5 with its
    passes), ms per step, device-busy ms, idle share, host launches a step,
    capture and instantiation seconds, pool MB."""
    import torch

    from anime_recommendations_tpu_torch.train import step_graph

    batches = _step_batches()
    out = {}
    for label, optimizer in STEP_GRAPH_CASES.items():
        call = _entry_call(label)
        runs = {}
        for mode in ("eager", "captured"):
            graphs = step_graph.StepGraphs() if mode == "captured" else step_graph.EAGER
            state = _fresh_state(optimizer)
            rows = tuple(t.detach()[torch.from_numpy(ids).to(DEVICE)] for t, ids in (
                (state.model.user_emb, batches[0][0]), (state.model.anime_emb, batches[0][1])))
            run = _timed_steps(call, state, rows, batches, graphs)
            run["arrays"] = _state_arrays(run.pop("state"))
            runs[mode] = (run, graphs)
        (eager, _), (captured, graphs) = runs["eager"], runs["captured"]
        gaps, report = _check_replayed(label, eager, captured, graphs, label == "lazy_adam",
                                       1, STEP_CALLS - 2)
        k1 = "fused_adam_gather" if label == "pipelined_kernel_gather" else "fused_adam"
        if optimizer in FUSED and (captured["launches"][k1] != 2 * STEP_GRAPH_STEPS
                                   or captured["launches"]["fused_adam_tiles"]
                                   != 2 * STEP_GRAPH_STEPS):
            raise AssertionError(f"[phase 15] {label}: launches {captured['launches']}, "
                                 f"expected {2 * STEP_GRAPH_STEPS} of {k1} and its first pass")
        graphs.release()
        out[label] = _step_row(label, card, eager, captured, gaps, report)
        print(f"[phase 15] {label} ({card}): {json.dumps(out[label])}", flush=True)
    return out


def _sharded_call(step):
    """call(state, rows, cols, next_cols, lr) of ShardedTrainStep.train_step."""

    def call(state, rows, cols, nxt, lr):
        state, loss, mse = step.train_step(state, *cols, lr)
        return state, rows, (loss, mse)

    return call


def phase_step_graph_sharded(card: str) -> dict:
    """Phase 15b (on phase 7's NCCL group of world size 1): ShardedTrainStep
    at SHARDED_STEP_CASES, STEP_GRAPH_STEPS train_step calls eagerly and
    through a step-graph cache from one state on the same batches (at 512
    slots each call reads its round counts before its replay), then
    eval_sums and grads three times each through the cache: everything
    bit-equal to the eager calls; the timings of phase_step_graph."""
    import torch

    from anime_recommendations_tpu_torch.parallel.mesh import make_world
    from anime_recommendations_tpu_torch.parallel.sharded_train import ShardedTrainStep
    from anime_recommendations_tpu_torch.parallel.trainer import init_placed_state
    from anime_recommendations_tpu_torch.train import step_graph

    _, vocab, _, _ = _dataset()
    batches = _step_batches()
    world = make_world(1, 1, DEVICE)
    out = {}
    for label, (optimizer, capacity, routing) in SHARDED_STEP_CASES.items():
        runs = {}
        for mode in ("eager", "captured"):
            # A step each: the rounds its plans run grow from its first call.
            step = ShardedTrainStep(world, l2_reg_factor=1e-4, routing=routing,
                                    optimizer=optimizer, capacity=capacity)
            graphs = step_graph.StepGraphs() if mode == "captured" else step_graph.EAGER
            state = init_placed_state(world, vocab.n_users, vocab.n_anime, D,
                                      torch.Generator().manual_seed(SEED), routing=routing)
            run = _timed_steps(_sharded_call(step), state, (), batches, graphs)
            state = run.pop("state")
            with _step_cache(graphs):    # three calls each: eager, captured, replayed
                run["evals"] = [step.eval_sums(state.model, state.model.bn_state(), *batches[i])
                                for i in range(3)]
                run["grads"] = [step.grads(state, *batches[i]) for i in range(3)]
            run["arrays"] = _state_arrays(state)
            runs[mode] = (run, graphs)
        (eager, _), (captured, graphs) = runs["eager"], runs["captured"]
        for i in range(3):
            if not all(torch.equal(a, b) for a, b in zip(captured["evals"][i], eager["evals"][i])):
                raise AssertionError(f"[phase 15b] {label}: replayed eval sums {i} differ")
            if not all(torch.equal(captured["grads"][i][k], g)
                       for k, g in eager["grads"][i].items()):
                raise AssertionError(f"[phase 15b] {label}: replayed gradients {i} differ")
        # The train steps' graphs, then eval_sums' and grads' (one each, at
        # the final rounds), and where the plans read their round counts
        # (512 slots) the plans' graph, replayed before each call from its
        # second.
        captures, hits = _expected_cache(_padded_round_keys(capacity, batches))
        if capacity is not None:
            captures, hits = captures + 1, hits + STEP_CALLS + 6 - 2
        gaps, report = _check_replayed(label, eager, captured, graphs, False,
                                       captures + 2, hits + 2)
        k1 = "fused_adam" if capacity is None else "fused_adam_dense"
        if optimizer == "fused_adam" and captured["launches"][k1] != 2 * STEP_GRAPH_STEPS:
            raise AssertionError(f"[phase 15b] {label}: launches {captured['launches']}")
        graphs.release()
        out[label] = _step_row(label, card, eager, captured, gaps, report)
        del runs, eager, captured
        print(f"[phase 15b] {label}, world size 1 on NCCL ({card}): {json.dumps(out[label])}",
              flush=True)
    return out


# ---- phase 10 ------------------------------------------------------------------

# scaling_bench's defaults (the JAX harness's): global batch and timed steps,
# after its 3 warm-up steps.
SCALING_BATCH, SCALING_STEPS, SCALING_WARM = 8192, 30, 3
SCALING_RUNS = (("alltoall", "adam"), ("alltoall", "fused_adam"), ("psum", "adam"))
SORT_STEPS = 10   # the profiled window of 10c


def _psum_runs(card: str, trained: dict) -> dict:
    """10a: step_train with routing=psum, then with shard_anime_table too: one
    adam epoch each against phase 5's first; the routed optimizers refused;
    a timed psum epoch."""
    from anime_recommendations_tpu_torch.config import Config
    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.parallel.trainer import ShardedTrainer
    from anime_recommendations_tpu_torch.pipeline.runner import PipelineRunner, store_root

    train, _ = _train_split()
    steps = -(-len(train) // BATCH)
    out = {"history_gap": {}, "refused": {}}
    with tempfile.TemporaryDirectory() as tmp:
        _write_store(store_root(Config(), tmp))
        for label, sets in (("psum", []), ("psum_shard_anime", ["parallel.shard_anime_table=true"])):
            cfg = Config().with_overrides([
                "model.optimizer=adam", "model.epochs=1", "model.export_weight_csvs=false",
                "model.device_loop=true", "parallel.routing=psum", *sets])
            runner = PipelineRunner(cfg, tmp, device=DEVICE)
            before = dict(_kernels.launches)
            result, seconds = _host_timed(runner.step_train)
            hist = result.history
            if len(hist) != 1 or not np.isfinite(hist.to_numpy()).all():
                raise AssertionError(f"{label}: history {hist.to_dict('list')}")
            gap = _history_gap(hist, trained["history"]["adam"].iloc[:1])
            out["history_gap"][label] = gap
            launched = {k: v - before.get(k, 0) for k, v in _kernels.launches.items()}
            print(f"[phase 10] {label} step_train, world size 1 on NCCL: {steps} steps, fit in "
                  f"{seconds:.1f} s, launches {json.dumps(launched)}; history "
                  f"{json.dumps(hist.to_dict('list'))}; largest relative gap to phase 5's first "
                  f"adam epoch {json.dumps(gap)}, accepted {json.dumps(FUSED_TOL)}", flush=True)
            if any(gap[c] > FUSED_TOL[c] for c in FUSED_TOL):
                raise AssertionError(f"{label}: history does not track phase 5's adam")
    for optimizer in ("lazy_adam", "fused_adam"):
        try:
            ShardedTrainer(batch_size=BATCH, optimizer=optimizer, routing="psum",
                           verbose=False, device=DEVICE)
        except ValueError as err:
            out["refused"][optimizer] = str(err)
        else:
            raise AssertionError(f"routing=psum accepted {optimizer}")
    print(f"[phase 10] routing=psum refuses: {json.dumps(out['refused'])}", flush=True)
    row = out["timed"] = _routed_graph_case(card, "psum", ("adam", None, "psum"))
    print(f"[phase 10] psum adam: ms/step eager {row['eager']['ms_per_step']:.3f}, captured "
          f"{row['captured']['ms_per_step']:.3f}; one-device (phase 13) "
          f"{trained['timed']['adam']['ms_per_step']:.3f} ({card})", flush=True)
    return out


def _scaling_runs(card: str) -> dict:
    """10b: parallel/scaling_bench at 1x1 with its defaults, in this process's
    NCCL group (measure_mesh; K1's launches counted), then its launcher
    (one torch.distributed.run of one NCCL rank) once."""
    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.parallel import scaling_bench

    out = {}
    for routing, optimizer in SCALING_RUNS:
        before = {k: _kernels.launches[k] for k in ("fused_adam_tiles", "fused_adam")}
        res = scaling_bench.measure_mesh(1, 1, N_USERS, N_ANIME, D, SCALING_BATCH, SCALING_STEPS,
                                         routing=routing, optimizer=optimizer, device=DEVICE)
        launched = {k: _kernels.launches[k] - v for k, v in before.items()}
        want = 2 * (SCALING_STEPS + SCALING_WARM) if optimizer == "fused_adam" else 0
        if launched != dict.fromkeys(launched, want):
            raise AssertionError(f"scaling_bench {routing} {optimizer}: launches {launched}, "
                                 f"expected {want} each")
        res["launches"] = launched
        out[f"{routing}_{optimizer}"] = res
        print(f"[phase 10] scaling_bench 1x1 ({card}): {json.dumps(res)}", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "anime_recommendations_tpu_torch.parallel.scaling_bench",
         "--meshes", "1x1", "--routing", "psum", "--device", "cuda"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"scaling_bench's launcher failed:\n{proc.stderr[-3000:]}")
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    if len(lines) != 2 or lines[0]["mesh"] != "1x1" or lines[1]["summary"][0]["efficiency"] != 1.0:
        raise AssertionError(f"scaling_bench's launcher printed {proc.stdout}")
    out["launcher"] = lines[0]
    print(f"[phase 10] scaling_bench --meshes 1x1 --routing psum through torch.distributed.run "
          f"({card}), {time.perf_counter() - t0:.1f} s: {json.dumps(lines)}", flush=True)
    return out


def _sorted_scatter_runs(card: str) -> dict:
    """10c: the device loop's adam epoch with sorted_scatter True and False
    (histories through Trainer.fit, then a timed epoch each from one state
    on the same shuffle and 10 profiled steps), and the two tables'
    embedding backward alone on a batch's ids, through take_rows and
    through the plain gather (both autograd's index backward, index_put_
    with accumulate)."""
    import torch

    from anime_recommendations_tpu_torch.models import two_tower as tt
    from anime_recommendations_tpu_torch.train import device_loop as dl
    from anime_recommendations_tpu_torch.train.trainer import Trainer

    train, holdout = _train_split()
    _, vocab, _, _ = _dataset()
    out = {"history": {}, "timed": {}, "backward": {}}
    data = dl.stage(train, BATCH, seed=SEED, device=DEVICE)
    steps = data.n // BATCH
    window = dl.DeviceData(*(x[:SORT_STEPS * BATCH] for x in data))
    for mode in (True, False):
        fit = Trainer(embedding_size=D, batch_size=BATCH, epochs=1, seed=SEED, verbose=False,
                      device=DEVICE, device_loop=True, sorted_scatter=mode).fit(
            train, holdout, vocab.n_users, vocab.n_anime)
        out["history"][str(mode)] = fit.history
        state = _fresh_state("adam")
        epoch = lambda seed: dl.train_epoch(state, data, torch.Generator().manual_seed(seed),
                                            1e-5, BATCH, 1e-4, sorted_scatter=mode,
                                            optimizer="adam")
        epoch(SEED)   # captures the epoch's graph; the next one replays it
        (_, losses, _, _), seconds = _host_timed(lambda: epoch(SEED + 1))
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"sorted_scatter={mode}: non-finite loss")
        ms_per_step = seconds * 1e3 / steps
        out["timed"][str(mode)] = dict(ms_per_step=ms_per_step, **_step_profile(
            lambda: dl.train_epoch(state, window, None, 1e-5, BATCH, 1e-4, shuffle=False,
                                   sorted_scatter=mode, optimizer="adam"),
            SORT_STEPS, ms_per_step))
    gap = _history_gap(out["history"]["True"], out["history"]["False"])
    out["history_gap"] = gap
    print(f"[phase 10] adam fit, sorted_scatter True vs False: histories "
          f"{json.dumps({k: v.to_dict('list') for k, v in out['history'].items()})}; "
          f"largest relative gap {json.dumps(gap)}, accepted 1e-5", flush=True)
    if any(v > 1e-5 for v in gap.values()):
        raise AssertionError("sorted_scatter changed the adam history")
    g = torch.randn((BATCH, D), generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
    for name, n, ids in (("users", vocab.n_users, data.users[:BATCH]),
                         ("anime", vocab.n_anime, data.anime[:BATCH])):
        table = torch.zeros((n, D), device=DEVICE, requires_grad=True)

        def backward(gather):
            rows = gather(table, ids)
            return lambda: torch.autograd.grad(rows, table, g, retain_graph=True)[0]

        take, plain = backward(tt.take_rows), backward(lambda t, i: t[i])
        want = plain()
        err = float((take() - want).abs().max())
        if err > 1e-6 * float(want.abs().max()):
            raise AssertionError(f"{name}: take_rows's backward differs from the plain by {err}")
        out["backward"][name] = {"max_abs_err": err,
                                 "take_rows_ms": _profiled(take, reps=10)["device_ms"],
                                 "plain_ms": _profiled(plain, reps=10)["device_ms"]}
    out["summary"] = {
        mode: {"ms_per_step": out["timed"][mode]["ms_per_step"],
               "device_ms_per_step": out["timed"][mode]["profiled_step"]["device_ms"],
               "embedding_backward_ms": sum(b[key] for b in out["backward"].values())}
        for mode, key in (("True", "take_rows_ms"), ("False", "plain_ms"))}
    print(f"[phase 10] adam device loop ({card}), by sorted_scatter: "
          f"{json.dumps(out['summary'])}; per table: {json.dumps(out['backward'])}; "
          f"10 profiled steps: {json.dumps(out['timed'])}", flush=True)
    return out


def _checkpoint_runs(card: str) -> dict:
    """10d: Trainer.fit through AsyncCheckpointer: the saved best state
    restores bit for bit; a fit stopped after 2 epochs and resumed from its
    checkpoint (its best epoch b) runs the uninterrupted 3-epoch fit's
    epochs b+1.. bit for bit (history and the last Adam state); a snapshot
    ignores in-place updates made before the write; the host time save
    blocks, against Checkpointer.save."""
    import copy

    import torch

    from anime_recommendations_tpu_torch.models.two_tower import PARAM_KEYS
    from anime_recommendations_tpu_torch.train import trainer as tr
    from anime_recommendations_tpu_torch.train.checkpoint import AsyncCheckpointer, Checkpointer

    train, holdout = _train_split()
    _, vocab, _, _ = _dataset()
    data = (train, holdout, vocab.n_users, vocab.n_anime)
    kw = dict(embedding_size=D, batch_size=BATCH, seed=SEED, verbose=False, device=DEVICE,
              device_loop=True)

    def arrays(state):
        return copy.deepcopy(tr.train_state_to_numpy(state))

    def equal(a, b, keys=None) -> bool:
        return all(np.array_equal(a[k], b[k]) for k in (keys or a))

    model_keys = list(PARAM_KEYS) + ["moving_mean", "moving_var"]
    adam_keys = [f"{m}.{k}" for m in ("mu", "nu") for k in PARAM_KEYS] + ["count"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        whole = tr.Trainer(epochs=3, checkpoint_dir=f"{tmp}/whole", **kw).fit(*data)
        restored = Checkpointer(f"{tmp}/whole").restore(_fresh_state("adam"))
        # The fit returns its best model and its last Adam state.
        if not equal(arrays(restored), arrays(whole.state),
                     model_keys + (adam_keys if whole.best_epoch == 2 else [])):
            raise AssertionError("the checkpoint does not restore the fit's best state")
        cut = tr.Trainer(epochs=2, checkpoint_dir=f"{tmp}/cut", **kw).fit(*data)
        resumed = tr.Trainer(epochs=3, checkpoint_dir=f"{tmp}/cut", **kw).fit(*data, resume=True)
        b = cut.best_epoch
        if (not np.array_equal(resumed.history.to_numpy(), whole.history.iloc[b + 1:].to_numpy())
                or not equal(arrays(resumed.state), arrays(whole.state), adam_keys)):
            raise AssertionError(f"the fit resumed after epoch {b}, "
                                 f"{resumed.history.to_dict('list')}, is not the uninterrupted "
                                 f"one's {whole.history.to_dict('list')}")
        out.update(history=whole.history.to_dict("list"), best_epoch=whole.best_epoch,
                   resumed_after=b)
        state = whole.state
        before = arrays(state)
        ck = AsyncCheckpointer(f"{tmp}/snap")
        ck.save(0, state)
        with torch.no_grad():
            state.model.user_emb.add_(1.0)
            state.adam.nu["user_emb"].mul_(2.0)
        ck.close()
        if not equal(arrays(Checkpointer(f"{tmp}/snap").restore(_fresh_state("adam"))), before):
            raise AssertionError("an in-place update reached the snapshot")
        times = {"async_save": [], "async_on_disk": [], "sync_save": []}
        ck, sync = AsyncCheckpointer(f"{tmp}/async"), Checkpointer(f"{tmp}/sync")
        for step in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(step, state)
            times["async_save"].append((time.perf_counter() - t0) * 1e3)
            ck.wait()
            times["async_on_disk"].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sync.save(step, state)
            times["sync_save"].append((time.perf_counter() - t0) * 1e3)
        ck.close()
    out["host_ms"] = {k: statistics.median(v) for k, v in times.items()}
    out["mb"] = sum(v.nbytes for v in before.values()) / 1e6
    print(f"[phase 10] AsyncCheckpointer ({card}): the best state (epoch {out['best_epoch']}) "
          f"restored bit for bit, the fit resumed after epoch {out['resumed_after']} equals the "
          f"uninterrupted one, the snapshot ignores an in-place update; history "
          f"{json.dumps(out['history'])}; host ms, median of 3, a {out['mb']:.0f} MB "
          f"state: {json.dumps(out['host_ms'])}", flush=True)
    return out


def phase_psum(card: str, trained: dict) -> dict:
    """Phase 10 on phase 7's NCCL group: psum, scaling_bench, take_rows and
    AsyncCheckpointer. The counters are reset before it and read after it:
    K1 and its first pass run in scaling_bench's fused_adam, dense_adam in
    every training, nothing else."""
    from anime_recommendations_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.launches.clear()
    out = {"psum": _psum_runs(card, trained), "scaling": _scaling_runs(card),
           "sorted_scatter": _sorted_scatter_runs(card), "checkpoint": _checkpoint_runs(card)}
    out["launches"] = dict(_kernels.launches)
    want = 2 * (SCALING_STEPS + SCALING_WARM)
    k1 = {k: v for k, v in out["launches"].items() if k != "dense_adam"}
    if k1 != {"fused_adam_tiles": want, "fused_adam": want} or not out["launches"].get(
            "dense_adam"):
        raise AssertionError(f"phase 10 launched {out['launches']}: expected K1 and its first "
                             f"pass {want} times each (scaling_bench's fused_adam), the dense "
                             f"Adam of every step, nothing else")
    out["wall_s"] = time.perf_counter() - t0
    print(f"[phase 10] launches {json.dumps(out['launches'])}; wall time {out['wall_s']:.1f} s",
          flush=True)
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
    _kernels.launches.clear()
    _, q256 = topk.cosine_topk(sh_q, hot, 10)
    _, q8 = topk.cosine_topk(sh_q, hot[:8], 10)
    if _kernels.launches["packed_topk_int8_mma"] != 2:
        raise AssertionError(f"the int8 scans did not take the tensor cores: {_kernels.launches}")
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


# ---- phase 9 -------------------------------------------------------------------

# The pipeline's configuration: phase 3's synthetic data (seed SEED, every
# user kept), D = 128, batches of 10,000, fused_adam; depth cut to
# PIPELINE_EPOCHS. The similar_anime and model_recs filters are off (as in
# tests/test_pipeline.py's small config), so the dense oracle needs only the
# stored weights, the catalog and the ratings; user_recs takes a random user
# outside the flow, so it scans for its similar users (in the flow it reads
# them from similar_users.csv), and assert_flow is checked on the flow user.
PIPELINE_EPOCHS = 1
PIPELINE_SETS = [
    f"data.synthetic_users={N_USERS}", f"data.synthetic_anime={N_ANIME}",
    f"data.synthetic_interactions={N_RATINGS}", f"data.synthetic_seed={SEED}",
    "data.num_reviews=1", f"model.embedding_size={D}", f"model.batch_size={BATCH}",
    "model.optimizer=fused_adam", f"model.epochs={PIPELINE_EPOCHS}",
    "similarity.an_spec_genres=false", "similarity.spec_types=false",
    "users.ID_recs_from_flow=false", "users.recs_ID_from_conf=false",
    "model_recs.specify_types=false",
]
RECOMMEND_STEPS = ("similar_anime", "similar_users", "user_prefs", "user_recs", "model_recs")
# tests/test_pipeline.py:91-101's artifacts; the PNGs need matplotlib.
PIPELINE_ARTIFACTS = (
    "full_data_set.parquet", "all_anime.csv", "synopses.csv", "preprocessed_stats.parquet",
    "anime_nn_model.npz", "anime_nn_history.csv", "neural_network_loss.png",
    "similar_users.csv", "ID_used.csv", "user_prefs.csv", "user_recs.csv", "model_recs.csv",
    "favorite_genres.png", "favorite_source_material.png",
)
# bench.py:467-517's IVF protocol, with this script's seed, and BENCH_r05's
# recalls on it (the JAX package's records) less 0.03.
IVF_ROWS, IVF_CLUSTERS, IVF_QUERIES = 2_000_000, 2048, 64
IVF_RECALL_FLOOR = {8: 0.7109 - 0.03, 32: 0.9438 - 0.03}


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _counting_steps(runner, per_step: dict) -> None:
    """Make each of runner's steps record the kernel launches it makes into
    per_step[step] (run() calls the steps through getattr)."""
    from collections import Counter

    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.pipeline.runner import STEPS

    for step in STEPS:
        def counted(fn=getattr(runner, f"step_{step}"), step=step):
            before = Counter(_kernels.launches)
            fn()
            per_step[step] = dict(Counter(_kernels.launches) - before)
        setattr(runner, f"step_{step}", counted)


def _normalized(w):
    """Rows x * rsqrt(max(|x|^2, 1e-12)) in f32 (two_tower's clamp)."""
    import torch

    w = w.float()
    return w * torch.rsqrt(torch.clamp_min((w * w).sum(dim=1, keepdim=True), 1e-12))


def _pipeline_oracle(store, device, mrc) -> None:
    """tests/test_pipeline_values.py's checks of the similar_anime,
    similar_users and model_recs CSVs, against dense scores on the card from
    the stored weights, catalog and ratings alone (values within 1e-5, the
    same result set). model_recs keeps unwatched anime whose catalog Score
    lies within ``mrc``'s bounds ("Unknown" does not)."""
    import pandas as pd
    import torch

    art = store.get("anime_nn_model.npz:latest")
    with np.load(art.file("anime_nn_model.npz")) as z:
        w = {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device) for k in z.files}
    vocab = json.loads(art.file("vocab.json").read_text())
    user_ids, anime_ids = np.asarray(vocab["user_ids"]), np.asarray(vocab["anime_ids"])
    catalog = pd.read_csv(store.get("all_anime.csv:latest").file())
    anime_n, user_n = _normalized(w["anime_emb"]), _normalized(w["user_emb"])

    sim = next(store.get(f"{n}:latest") for n in store.names()
               if store.get(f"{n}:latest").metadata.get("Queried anime"))
    got = pd.read_csv(sim.file())
    q_id = int(catalog.loc[catalog["Name"] == sim.metadata["Queried anime"], "MAL_ID"].iloc[0])
    qi = int(np.flatnonzero(anime_ids == q_id)[0])
    v, i = _oracle_topk(anime_n, anime_n[[qi]], len(got), exclude=torch.tensor([qi], device=device))
    name_of = catalog.set_index("MAL_ID")["Name"]
    _close("pipeline similar_anime", got["Similarity"], v[0].cpu().numpy(), got["Name"],
           name_of.loc[anime_ids[i[0].cpu().numpy()]])

    got = pd.read_csv(store.get("similar_users.csv:latest").file())
    uid = int(store.get("similar_users.csv:latest").metadata["Queried user"])
    qi = int(np.flatnonzero(user_ids == uid)[0])
    v, i = _oracle_topk(user_n, user_n[[qi]], len(got), exclude=torch.tensor([qi], device=device))
    _close("pipeline similar_users", got["similarity"], v[0].cpu().numpy(),
           got["similar_users"], user_ids[i[0].cpu().numpy()])

    got = pd.read_csv(store.get("model_recs.csv:latest").file())
    uid = int(store.get("model_recs.csv:latest").metadata["Queried user"])
    stats = pd.read_parquet(store.get("preprocessed_stats.parquet:latest").file(),
                            columns=["user_id", "anime_id"])
    score = pd.to_numeric(catalog.set_index("MAL_ID")["Score"].reindex(anime_ids),
                          errors="coerce").to_numpy()
    keep = (~np.isin(anime_ids, stats.loc[stats["user_id"] == uid, "anime_id"])
            & (score >= mrc.min_score) & (score <= mrc.max_score))
    inv = torch.rsqrt(w["moving_var"] + 1e-3)   # the folded eval-mode head
    head = torch.stack([w["bn_gamma"] * w["dense_w"] * inv,
                        w["bn_gamma"] * (w["dense_b"] - w["moving_mean"]) * inv + w["bn_beta"]])
    qi = int(np.flatnonzero(user_ids == uid)[0])
    v, i = _oracle_topk(anime_n, user_n[[qi]], len(got), mask=torch.from_numpy(keep).to(device),
                        head=head.reshape(2))
    _close("pipeline model_recs", got["Prediction"], v[0].cpu().numpy(), got["anime_id"],
           anime_ids[i[0].cpu().numpy()])


def _same_answers(label, ctx, ref, cfg) -> int:
    """Every endpoint of the HTTP server, served from ``ctx`` and from
    ``ref`` with the same requests: the same rows, floats within 1e-5.
    Returns the number of requests compared."""
    from anime_recommendations_tpu_torch.serve.api import make_server

    servers = [make_server(c, cfg, host="127.0.0.1", port=0) for c in (ctx, ref)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()

    def close(a, b, where):
        if isinstance(a, float) or isinstance(b, float):
            if not (abs(a - b) <= 1e-5 or (a != a and b != b)):
                raise AssertionError(f"{label} {where}: {a} vs {b}")
        elif isinstance(a, dict):
            if a.keys() != b.keys():
                raise AssertionError(f"{label} {where}: keys {a.keys()} vs {b.keys()}")
            for key in a:
                close(a[key], b[key], where)
        elif isinstance(a, list):
            if len(a) != len(b):
                raise AssertionError(f"{label} {where}: {len(a)} vs {len(b)} items")
            for x, y in zip(a, b):
                close(x, y, where)
        elif a != b:
            raise AssertionError(f"{label} {where}: {a!r} vs {b!r}")

    rng = np.random.default_rng(SEED + 9)
    vocab, catalog = ctx.vocab, ctx.catalog
    name_of = dict(zip(catalog.anime["anime_id"], catalog.anime["Name"]))
    users = [int(u) for u in rng.choice(vocab.user_ids, size=16, replace=False)]
    names = [str(name_of[int(a)]) for a in rng.choice(vocab.anime_ids, size=6, replace=False)]
    requests = (
        [("similar_anime", dict(name=n, k=10)) for n in names[:3]]
        + [("similar_anime", dict(name=names[3], k=10, types="TV"))]
        + [("similar_users", dict(user_id=u, k=10)) for u in users[:3]]
        + [("user_prefs", dict(user_id=users[3]))]
        + [("user_recs", dict(user_id=u, k=10)) for u in users[4:7]]
        + [("model_recs", dict(user_id=u, k=10)) for u in users[7:10]]
        + [("similar_anime_batch", dict(names="|".join(names[4:6]), k=10)),
           ("model_recs_batch", dict(user_ids=",".join(map(str, users[10:13])), k=10)),
           ("similar_users_batch", dict(user_ids=",".join(map(str, users[13:16])), k=10))]
    )
    try:
        for endpoint, params in requests:
            bodies = []
            for server in servers:
                url = (f"http://127.0.0.1:{server.server_address[1]}/{endpoint}?"
                       f"{urllib.parse.urlencode(params)}")
                with urllib.request.urlopen(url, timeout=120) as resp:
                    bodies.append(json.loads(resp.read()))
            if not bodies[0]:
                raise AssertionError(f"{label} /{endpoint}: empty answer")
            close(bodies[0], bodies[1], f"/{endpoint} {params}")
    finally:
        for server, thread in zip(servers, threads):
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    return len(requests)


def _ivf_cpu_agreement(label, ctx, rng) -> dict:
    """ivf_topk of an int8-storage context on the card against the same
    indexes copied to the CPU (probing every cluster is not exact for int8
    storage, so the CPU result of the same index is the reference): 64
    users' similar users (self excluded), 64 users' headed scores over the
    catalog, 32 titles' similar anime. Values within 1e-5; rows equal
    unless their true scores tie within 1e-6."""
    import torch

    from anime_recommendations_tpu_torch.ops.ivf import IVFIndex
    from anime_recommendations_tpu_torch.ops.topk import cosine_topk
    from anime_recommendations_tpu_torch.ops.scoring import score_topk

    def cpu(index):
        return IVFIndex(*(None if t is None else t.cpu() for t in index))

    users = torch.from_numpy(rng.choice(ctx.vocab.n_users, 64, replace=False)).to(ctx.device)
    anime = torch.from_numpy(rng.choice(ctx.vocab.n_anime, 32, replace=False)).to(ctx.device)
    probes = ctx.topk_kwargs["probes"]
    cases = {
        "similar_users": (lambda t, d: cosine_topk(t, ctx.user_norm[users].to(d), 10,
                                                   exclude=users.to(d), probes=probes),
                          ctx.user_table(), ctx.user_norm, users, None),
        "model_recs": (lambda t, d: score_topk(t, ctx.user_norm[users].to(d), ctx.head.to(d), 10,
                                               probes=probes),
                       ctx.anime_table(), ctx.user_norm, users, ctx.head),
        "similar_anime": (lambda t, d: cosine_topk(t, ctx.anime_norm[anime].to(d), 10,
                                                   exclude=anime.to(d), probes=probes),
                          ctx.anime_table(), ctx.anime_norm, anime, None),
    }
    out = {}
    for name, (scan, index, qtable, rows, head) in cases.items():
        v, i = scan(index, ctx.device)
        pv, pi = scan(cpu(index), "cpu")
        err = float((v.cpu() - pv).abs().max())
        q = qtable[rows]
        gap = (_row_scores(index.table, q, i.clamp_min(0), head).cpu()
               - _row_scores(index.table, q, pi.clamp_min(0).to(ctx.device), head).cpu()).abs()
        differ = int(((i.cpu() != pi) & (gap > 1e-6)).sum())
        if err > 1e-5 or differ:
            raise AssertionError(f"{label} {name}: the card's IVF result differs from the CPU's "
                                 f"(values by {err}, {differ} rows)")
        out[name] = err
    return out


def _ivf_overlap(ctx, ref, rng) -> dict:
    """Mean top-10 overlap of ``ctx``'s scans with ``ref``'s: 256 users'
    similar users and headed scores, 256 titles' similar anime."""
    import torch

    from anime_recommendations_tpu_torch.ops.scoring import score_topk
    from anime_recommendations_tpu_torch.ops.topk import cosine_topk

    users = torch.from_numpy(rng.choice(ctx.vocab.n_users, 256, replace=False)).to(ctx.device)
    anime = torch.from_numpy(rng.choice(ctx.vocab.n_anime, 256, replace=False)).to(ctx.device)
    out = {}
    for name, scan in {
        "similar_users": lambda c: cosine_topk(c.user_table(), c.user_norm[users], 10,
                                               exclude=users, **c.topk_kwargs),
        "model_recs": lambda c: score_topk(c.anime_table(), c.user_norm[users], c.head, 10,
                                           **c.topk_kwargs),
        "similar_anime": lambda c: cosine_topk(c.anime_table(), c.anime_norm[anime], 10,
                                               exclude=anime, **c.topk_kwargs),
    }.items():
        out[name] = _overlap(scan(ctx)[1], scan(ref)[1])
    return out


def phase_ivf_bench(card: str, device: str = "cuda") -> dict:
    """bench.py:467-517's protocol: a 2,000,000 x 128 table of unit rows
    from a rank-16 latent, build_ivf(2048 clusters, 8 iterations, seed 3),
    64 queries' recall@10 at 8 and 32 probes against K3's exact scan, and the
    device ms of one query at p8, p32 and through the exact scans (K3, and
    the two-stage K2 scan)."""
    import torch

    from anime_recommendations_tpu_torch.bench import latent_table
    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.ops.ivf import build_ivf, ivf_topk
    from anime_recommendations_tpu_torch.ops.topk import masked_topk

    rng = np.random.default_rng(SEED)
    w = latent_table(rng, IVF_ROWS, D, device)
    _sync(device)
    t0 = time.perf_counter()
    index = build_ivf(w, n_clusters=IVF_CLUSTERS, iters=8, seed=3)
    _sync(device)
    out = {"card": card, "rows": IVF_ROWS, "clusters": index.n_clusters,
           "bucket_cap": index.bucket_cap, "spill": int((index.spill >= 0).sum()),
           "build_s": time.perf_counter() - t0}
    q = w[torch.from_numpy(rng.integers(0, IVF_ROWS, IVF_QUERIES)).to(device)]
    before = _kernels.launches["exact_topk"]
    _, exact = masked_topk(w, q, 10, exact_scan=True)
    if device == "cuda" and _kernels.launches["exact_topk"] != before + 1:
        raise AssertionError("the exact oracle did not launch exact_topk")
    one = w[int(rng.integers(0, IVF_ROWS))][None, :].contiguous()
    for probes in (8, 32):
        _, ids = ivf_topk(index, q, 10, probes=probes)
        out[f"p{probes}_recall_at10"] = _overlap(ids, exact)
        prof = _profiled(lambda p=probes: ivf_topk(index, one, 10, probes=p))
        out[f"q1_p{probes}_device_ms"] = prof["device_ms"]
        out[f"q1_p{probes}_wall_ms"] = prof["wall_ms"]
    for label, kw in (("exact_k3", dict(exact_scan=True)), ("two_stage_k2", {})):
        prof = _profiled(lambda kw=kw: masked_topk(w, one, 10, **kw))
        out[f"q1_{label}_device_ms"] = prof["device_ms"]
        out[f"q1_{label}_wall_ms"] = prof["wall_ms"]
    print(f"[phase 9] IVF at {IVF_ROWS:,} rows ({card}): {json.dumps(out)}", flush=True)
    below = {p: out[f"p{p}_recall_at10"] for p, floor in IVF_RECALL_FLOOR.items()
             if out[f"p{p}_recall_at10"] < floor}
    if below:
        raise AssertionError(f"IVF recall@10 below BENCH_r05's less 0.03: {below}")
    del w, index
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_pipeline(card: str, device: str = "cuda") -> dict:
    """9a: PipelineRunner.run() over the eight steps at full width on the
    card, with the artifacts, assert_flow, the dense oracle and the launches
    of each step checked, then ``cli pipeline`` over the five recommend
    steps in a subprocess on the same run, whose CSVs must equal these. 9b:
    IVF contexts on the trained store (f32 probing every cluster against the
    exact context at every endpoint, int8 against the CPU, the default 16
    probes' overlap), then phase_ivf_bench."""
    import pandas as pd
    import torch

    from anime_recommendations_tpu_torch.config import Config
    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.pipeline.runner import (
        STEPS,
        PipelineRunner,
        context_from_store,
    )
    from anime_recommendations_tpu_torch.recommend.clouds import have_matplotlib
    from anime_recommendations_tpu_torch.utils.profiling import device_memory_stats, trace

    t_phase = time.perf_counter()
    cfg = Config().with_overrides(PIPELINE_SETS)
    print(f"[phase 9] the pipeline at {N_USERS:,} x {N_ANIME:,} x {N_RATINGS:,}, D = {D}, "
          f"fused_adam; depth cut to {PIPELINE_EPOCHS} epoch", flush=True)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        runner = PipelineRunner(cfg, tmp, device=device)
        per_step: dict[str, dict] = {}
        _counting_steps(runner, per_step)
        _kernels.launches.clear()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        timings = runner.run()
        _sync(device)
        launched = dict(_kernels.launches)
        print(f"[phase 9] launches by step: {json.dumps(per_step)}", flush=True)
        store = runner.store
        # Every step's launches, checked: K1 (and its first pass) twice per
        # training step; K4 twice for the one context build (in the first
        # recommend step); K2 in each step that scans.
        rows = store.get("preprocessed_stats.parquet:latest").metadata["rows_out"]
        n_train = rows - min(cfg.model.test_size, max(rows // 10, 1))
        steps = -(-n_train // min(BATCH, n_train)) * PIPELINE_EPOCHS
        if device == "cuda":
            k1 = {k: per_step["train"].get(k, 0) for k in ("fused_adam_tiles", "fused_adam")}
            if k1 != dict.fromkeys(k1, 2 * steps) or per_step["train"].get("dense_adam") != steps:
                raise AssertionError(f"train launched {per_step['train']} over {steps} steps")
            if per_step["similar_anime"].get("l2_normalize") != 2 or launched["l2_normalize"] != 2:
                raise AssertionError("the context build did not launch l2_normalize twice")
            for step in ("similar_anime", "similar_users", "user_recs", "model_recs"):
                if sum(per_step[step].get(c, 0) for c in K2_COUNTERS) < 1:
                    raise AssertionError(f"step {step} launched no K2: {per_step[step]}")
        # Artifacts, the golden header, the flow.
        skipped = [] if have_matplotlib() else [a for a in PIPELINE_ARTIFACTS if a.endswith(".png")]
        missing = [a for a in PIPELINE_ARTIFACTS
                   if a not in skipped and not store.exists(f"{a}:latest")]
        if missing or not all(store.exists(f"{a}:latest") for a in (
                "user_recs_preferences.csv", "anime_weights.csv", "user_weights.csv")):
            raise AssertionError(f"artifacts missing: {missing}")
        print(f"[phase 9] every artifact logged; PNGs skipped (no matplotlib): {skipped}",
              flush=True)
        header = store.get("anime_nn_history.csv:latest").file().read_text().splitlines()[0]
        if header != ",loss,mse,val_loss,val_mse,lr":
            raise AssertionError(f"history header {header!r}")
        flow_user = runner._flow_user()
        if not runner.assert_flow(flow_user):
            raise AssertionError("assert_flow failed")
        if int(store.get("model_recs.csv:latest").metadata["Queried user"]) != flow_user:
            raise AssertionError("model_recs did not take the flow user")
        _pipeline_oracle(store, device, cfg.model_recs)
        record = json.loads((runner.run_dir / "timings.json").read_text())
        out.update(timings=timings, step_timer=record["step_timer"], launches=launched,
                   launches_by_step=per_step, memory=device_memory_stats())
        print(f"[phase 9] timings.json, wall s by step ({card}): {json.dumps(timings)}",
              flush=True)
        print(f"[phase 9] StepTimer sections: {json.dumps(record['step_timer'])}", flush=True)
        print(f"[phase 9] device memory: {json.dumps(out['memory'])}", flush=True)

        # The CLI over the five recommend steps on the same run: the same
        # seed picks the same title and users, so the same CSVs.
        versions = {n: store.versions(n)[-1] for n in store.names()}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "anime_recommendations_tpu_torch.cli", "pipeline",
             "--steps", *RECOMMEND_STEPS, "--run-dir", tmp, "--device", device,
             *[a for s in PIPELINE_SETS for a in ("--set", s)]],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise AssertionError(f"cli pipeline failed:\n{proc.stderr[-4000:]}")
        cli_timings = json.loads(proc.stdout)
        compared = 0
        for name in store.names():
            if store.versions(name)[-1] == versions.get(name):
                continue   # not logged again by the CLI
            new, old = store.get(f"{name}:latest"), store.get(f"{name}:v{versions[name]}")
            if new.metadata != old.metadata or [f.name for f in new.files()] != [
                    f.name for f in old.files()]:
                raise AssertionError(f"cli pipeline: {name} differs in metadata or files")
            for a, b in zip(new.files(), old.files()):
                if a.suffix == ".csv":
                    pd.testing.assert_frame_equal(pd.read_csv(a), pd.read_csv(b),
                                                  check_exact=False, atol=1e-6, rtol=0)
                    compared += 1
        if compared < 6:
            raise AssertionError(f"cli pipeline: {compared} CSVs compared")
        print(f"[phase 9] cli pipeline {' '.join(RECOMMEND_STEPS)} in a subprocess "
              f"({time.perf_counter() - t0:.1f} s): {compared} CSVs equal the in-process ones; "
              f"its timings {json.dumps({k: v for k, v in cli_timings.items() if k in STEPS})}",
              flush=True)

        # The recommend steps again (new picks from the runner's generator)
        # under torch.profiler: their wall time against the card's busy time.
        trace_dir = Path(tmp) / "trace"
        t0 = time.perf_counter()
        with trace(trace_dir) as prof:
            runner.run(list(RECOMMEND_STEPS))
            _sync(device)
        wall = time.perf_counter() - t0
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        out["recommend_profile"] = {"wall_s": wall, "device_busy_s": busy,
                                    "idle_share": 1 - busy / wall,
                                    "trace_files": len(list(trace_dir.glob("trace_*.json")))}
        if out["recommend_profile"]["trace_files"] != 1:
            raise AssertionError("utils.profiling.trace wrote no trace file")
        print(f"[phase 9] the five recommend steps again under torch.profiler ({card}): "
              f"{json.dumps(out['recommend_profile'])}", flush=True)

        # 9b: IVF contexts on the trained store.
        rng = np.random.default_rng(SEED + 10)
        exact = context_from_store(cfg, tmp, device=device)
        # Config.with_overrides changes the config it is given: a new one each.
        probe_all = ["similarity.ann=ivf", "similarity.ann_probes=100000"]
        ivf_cfg = Config().with_overrides(PIPELINE_SETS + probe_all)
        before = _kernels.launches["l2_normalize"]
        t0 = time.perf_counter()
        ivf_all = context_from_store(ivf_cfg, tmp, device=device)
        _sync(device)
        if device == "cuda" and _kernels.launches["l2_normalize"] != before + 2:
            raise AssertionError("the IVF context build did not launch l2_normalize twice")
        build_s = time.perf_counter() - t0
        n = _same_answers("IVF f32, every cluster probed", ivf_all, exact, cfg)
        print(f"[phase 9] IVF f32 context ({ivf_all.anime_table().n_clusters} anime and "
              f"{ivf_all.user_table().n_clusters} user clusters, built in {build_s:.1f} s), "
              f"every cluster probed: {n} requests through the HTTP server answered as the "
              f"exact context answers them", flush=True)
        int8 = context_from_store(Config().with_overrides(
            PIPELINE_SETS + probe_all + ["similarity.retrieval_dtype=int8"]), tmp, device=device)
        err = _ivf_cpu_agreement("IVF int8", int8, rng)
        print(f"[phase 9] IVF int8 context, every cluster probed: the card's results are the "
              f"CPU's on the same indexes (largest value error {json.dumps(err)})", flush=True)
        probes = Config().similarity.ann_probes
        default = dataclasses.replace(ivf_all, topk_kwargs={"probes": probes})
        out["ivf_overlap_p16"] = _ivf_overlap(default, exact, rng)
        print(f"[phase 9] IVF f32 at the default {probes} probes, top-10 overlap with the "
              f"exact context: {json.dumps(out['ivf_overlap_p16'])}", flush=True)
        del exact, ivf_all, int8, default
    out["ivf_bench"] = phase_ivf_bench(card, device)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[phase 9] wall time {out['wall_s']:.1f} s", flush=True)
    return out


# ---- phase 11 ------------------------------------------------------------------

BENCH_TIMEOUT_S = 600
# The benchmark's gates: PERF.md section 2's limits. Exact retrieval reads
# 1.0; the trained-table overlaps reach BENCH_r05's record; IVF recall reaches
# BENCH_r05's less 0.03 (IVF_RECALL_FLOOR).
BENCH_EXACT = ("topk_overlap_vs_oracle", "topk_q256_overlap_vs_oracle",
               "score_topk_overlap_vs_oracle")
BENCH_TRAINED = ("topk_trained_twostage_vs_exact_overlap", "topk_trained_int8_vs_exact_overlap",
                 "topk_trained_bf16_vs_bf16exact_overlap",
                 "topk_trained350k_twostage_vs_exact_overlap")
BENCH_TRAINED_FLOOR = 0.99961
# The counters of every kernel on the bench's path: K1, K2's two branches,
# K2q's two, K3, K4.
BENCH_KERNELS = ("fused_adam", *K2_COUNTERS, *INT8_COUNTERS, "exact_topk", "l2_normalize")


def bench_key_patterns(path: Path = REPO / "bench.py") -> tuple[dict, set]:
    """The keys bench.py writes into ``details``, read from its source: a
    regular expression per key, mapped to whether bench.py sets it only
    under an ``if``; and the keys of the dict it starts from. An f-string's
    field becomes each value its name takes, where the source says: the
    constants of a ``for`` over a literal tuple, or the constant arguments
    of every call of the function whose parameter it is. Any other field
    matches anything."""
    import ast
    import itertools
    import re
    from collections import defaultdict

    tree = ast.parse(path.read_text())
    calls = defaultdict(list)   # function name -> each call's constant arguments
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            calls[node.func.id].append([a.value if isinstance(a, ast.Constant) else None
                                        for a in node.args])

    def loop_values(target, items) -> dict:
        if not isinstance(items, (ast.Tuple, ast.List)):
            return {}
        names = [target] if isinstance(target, ast.Name) else list(target.elts)
        out = {}
        for pos, name in enumerate(names):
            values = [el if isinstance(target, ast.Name) else
                      (el.elts[pos] if isinstance(el, ast.Tuple) else None) for el in items.elts]
            if isinstance(name, ast.Name) and all(isinstance(v, ast.Constant) for v in values):
                out[name.id] = [v.value for v in values]
        return out

    def expand(node, scope) -> list[str]:
        parts = node.values if isinstance(node, ast.JoinedStr) else [node]
        options = []
        for part in parts:
            if isinstance(part, ast.Constant):
                options.append([re.escape(str(part.value))])
            elif isinstance(part.value, ast.Name) and part.value.id in scope:
                options.append([re.escape(str(v)) for v in scope[part.value.id]])
            else:
                options.append([".+"])
        return ["".join(combo) for combo in itertools.product(*options)]

    patterns, initial = {}, set()

    def visit(node, scope, conditional):
        if isinstance(node, ast.FunctionDef):
            scope = dict(scope)
            for i, arg in enumerate(node.args.args):
                values = [c[i] if i < len(c) else None for c in calls[node.name]]
                if values and None not in values:
                    scope[arg.arg] = values
        elif isinstance(node, ast.For):
            scope = {**scope, **loop_values(node.target, node.iter)}
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
                        and target.value.id == "details"):
                    for key in expand(target.slice, scope):
                        patterns[key] = patterns.get(key, True) and conditional
                elif (isinstance(target, ast.Name) and target.id == "details"
                      and isinstance(node.value, ast.Dict)):
                    initial.update(k.value for k in node.value.keys)
        for child in ast.iter_child_nodes(node):
            visit(child, scope, conditional or isinstance(node, ast.If))

    visit(tree, {}, False)
    return patterns, initial


def bench_key_mismatch(details: dict) -> tuple[list, list]:
    """(bench.py's keys that ``details`` lacks, ``details``' keys that are
    not bench.py's): every key bench.py always writes is required but
    scan_harness_base_ms, which the port has no counterpart of; the keys it
    writes under an ``if`` may be absent."""
    import re

    patterns, initial = bench_key_patterns()
    missing = sorted(p for p, conditional in patterns.items()
                     if p != "scan_harness_base_ms" and not conditional
                     and not any(re.fullmatch(p, k) for k in details))
    missing += sorted(initial - details.keys())
    unknown = sorted(k for k in details if k not in initial and k != "scan_harness_base_ms"
                     and not any(re.fullmatch(p, k) for p in patterns))
    return missing, unknown


def phase_bench(card: str) -> None:
    """``cli bench`` in a fresh process (host-clock numbers read slower in
    this script's own process than in a fresh one: PERF.md section 6): its
    result line and launches line, every key of bench.py but
    scan_harness_base_ms, the exact and trained-table overlaps, IVF recall
    and a launch of every kernel on its path."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "anime_recommendations_tpu_torch.cli", "bench"],
        cwd=REPO, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
    )
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if line.startswith("[bench] ") and not line.startswith("[bench] launches"):
            print(f"[phase 11] {line}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"cli bench failed:\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    launches = json.loads(next(line for line in proc.stderr.splitlines()
                               if line.startswith("[bench] launches "))[len("[bench] launches "):])
    details = result["details"]
    print(f"[phase 11] cli bench in a fresh process, {wall:.1f} s ({card}): "
          f"{len(lines)} stdout line(s), metric {result['metric']} = {result['value']} "
          f"{result['unit']}, vs_baseline {result['vs_baseline']}", flush=True)
    print(f"[phase 11] details {json.dumps(details)}", flush=True)
    print(f"[phase 11] launches {json.dumps(launches)}", flush=True)
    missing, unknown = bench_key_mismatch(details)
    faults = []
    if len(lines) != 1 or result["metric"] != "train_examples_per_sec":
        faults.append(f"stdout {lines[:-1]}, metric {result['metric']}")
    if missing or unknown:
        faults.append(f"keys missing {missing}, not bench.py's {unknown}")
    if card.split(",")[0] not in details["device"]:
        faults.append(f"device {details['device']!r} is not the card {card!r}")
    faults += [f"{k} = {details.get(k)}" for k in BENCH_EXACT if details.get(k) != 1.0]
    faults += [f"{k} = {details.get(k)} < {BENCH_TRAINED_FLOOR}" for k in BENCH_TRAINED
               if not details.get(k, 0) >= BENCH_TRAINED_FLOOR]
    faults += [f"ivf2m_p{p}_recall_at10 = {details.get(f'ivf2m_p{p}_recall_at10')} < {floor}"
               for p, floor in IVF_RECALL_FLOOR.items()
               if not details.get(f"ivf2m_p{p}_recall_at10", 0) >= floor]
    faults += [f"{k} never launched" for k in BENCH_KERNELS if launches.get(k, 0) < 1]
    if faults:
        raise AssertionError(f"cli bench: {faults}")


# ---- phase 12 ------------------------------------------------------------------

# The downloaded dataset: phase 3's raw frames served over HTTP on 127.0.0.1
# under the config's file names (the ratings as a numeric CSV), and phase 9's
# configuration over ingest, preprocess, train and similar_anime with every
# raw file missing locally and downloading allowed. The configured query
# title names a real MyAnimeList anime, which a downloaded synthetic catalog
# lacks, and a downloaded run does not swap it for a random one (as in JAX),
# so the query is random. The weight CSVs are left out (24 s of phase 9's
# run, on no kernel's path).
DOWNLOAD_NAMES = {"stats": "user_stats.csv", "anime": "all_anime.csv",
                  "synopses": "synopses.csv"}
DOWNLOAD_STEPS = ["ingest", "preprocess", "train", "similar_anime"]


def _serve_dir(root: Path):
    """A ThreadingHTTPServer on 127.0.0.1 (a free port) serving ``root`` from
    a thread of this process."""
    import http.server

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, directory=str(root), **kwargs)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@contextlib.contextmanager
def _timed_downloads():
    """Time each call of data.ingest._download in this process: the client's
    request, its reads from the socket and its writes into the cache. Yields
    the list that (bytes, seconds) is appended to for each file."""
    from anime_recommendations_tpu_torch.data import ingest

    plain, fetched = ingest._download, []

    def timed(url, dest):
        t0 = time.perf_counter()
        path = plain(url, dest)
        fetched.append((path.stat().st_size, time.perf_counter() - t0))
        return path

    ingest._download = timed
    try:
        yield fetched
    finally:
        ingest._download = plain


def phase_download(card: str) -> dict:
    """Phase 12: PipelineRunner over DOWNLOAD_STEPS with the raw files
    downloaded from a local server; the cache bytes, the ingested ratings
    and the source tag checked, K1, K4 and K2 counted per step as in 9a;
    then ``cli ingest`` in a subprocess against the same server."""
    import pandas as pd
    import torch

    from anime_recommendations_tpu_torch.config import Config
    from anime_recommendations_tpu_torch.data.ingest import _read_any
    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.pipeline.runner import PipelineRunner

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        served = Path(tmp) / "served"
        served.mkdir()
        raw, catalog, synopses = _raw_frames()
        t0 = time.perf_counter()
        for frame, key in ((raw, "stats"), (catalog, "anime"), (synopses, "synopses")):
            frame.to_csv(served / DOWNLOAD_NAMES[key], index=False)
        sizes = {n: (served / n).stat().st_size for n in DOWNLOAD_NAMES.values()}
        print(f"[phase 12] served files written in {time.perf_counter() - t0:.1f} s: "
              f"{len(raw):,} ratings, {len(catalog):,} anime; bytes {json.dumps(sizes)}",
              flush=True)
        server = _serve_dir(served)
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            sets = [*PIPELINE_SETS, "data.allow_download=true", "similarity.random_anime=true",
                    "model.export_weight_csvs=false",
                    *[f"data.{key}_path={tmp}/missing/{name}"
                      for key, name in DOWNLOAD_NAMES.items()],
                    *[f"data.{key}_url={base}/{name}" for key, name in DOWNLOAD_NAMES.items()]]
            cfg = Config().with_overrides(sets)
            run_dir = Path(tmp) / "run"
            runner = PipelineRunner(cfg, run_dir, device="cuda")
            per_step: dict[str, dict] = {}
            _counting_steps(runner, per_step)
            _kernels.launches.clear()
            with _timed_downloads() as fetched:
                timings = runner.run(DOWNLOAD_STEPS)
            torch.cuda.synchronize()
            print(f"[phase 12] launches by step: {json.dumps(per_step)}", flush=True)
            store = runner.store
            for name in DOWNLOAD_NAMES.values():
                if (runner.run_dir / "cache" / name).read_bytes() != (served / name).read_bytes():
                    raise AssertionError(f"cache/{name} is not the served file")
            art = store.get("full_data_set.parquet:latest")
            if art.metadata.get("source") != "download":
                raise AssertionError(f"full_data_set.parquet metadata {art.metadata}")
            ingested = pd.read_parquet(art.file())
            pd.testing.assert_frame_equal(ingested, _read_any(served / DOWNLOAD_NAMES["stats"]))
            rows = store.get("preprocessed_stats.parquet:latest").metadata["rows_out"]
            n_train = rows - min(cfg.model.test_size, max(rows // 10, 1))
            steps = -(-n_train // min(BATCH, n_train)) * PIPELINE_EPOCHS
            k1 = {k: per_step["train"].get(k, 0) for k in ("fused_adam_tiles", "fused_adam")}
            if k1 != dict.fromkeys(k1, 2 * steps):
                raise AssertionError(f"train launched {per_step['train']} over {steps} steps")
            if per_step["similar_anime"].get("l2_normalize") != 2:
                raise AssertionError("the context build did not launch l2_normalize twice")
            if sum(per_step["similar_anime"].get(c, 0) for c in K2_COUNTERS) < 1:
                raise AssertionError(f"similar_anime launched no K2: {per_step['similar_anime']}")
            if len(fetched) != len(DOWNLOAD_NAMES):
                raise AssertionError(f"{len(fetched)} downloads, not {len(DOWNLOAD_NAMES)}")
            n_bytes, seconds = sum(b for b, _ in fetched), sum(t for _, t in fetched)
            out.update(timings=timings, launches=dict(_kernels.launches),
                       launches_by_step=per_step, downloaded_bytes=n_bytes,
                       download_s=seconds, download_mb_per_s=n_bytes / 1e6 / seconds)

            # ``cli ingest`` in a fresh process against the same server.
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "anime_recommendations_tpu_torch.cli", "ingest",
                 "--run-dir", str(Path(tmp) / "cli"), "--device", "cuda",
                 *[a for o in sets for a in ("--set", o)]],
                cwd=REPO, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"cli ingest exited with {proc.returncode}:\n{proc.stderr}")
            cli_s = time.perf_counter() - t0
        finally:
            server.shutdown()
            server.server_close()
        cli_store = PipelineRunner(cfg, Path(tmp) / "cli", device="cpu").store
        cli_art = cli_store.get("full_data_set.parquet:latest")
        pd.testing.assert_frame_equal(pd.read_parquet(cli_art.file()), ingested)
        if cli_art.metadata != art.metadata:
            raise AssertionError(f"cli ingest metadata {cli_art.metadata} != {art.metadata}")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[phase 12] the downloaded dataset ({card}): {len(ingested):,} ratings ingested, "
          f"the cache equal to the served bytes, source 'download', `cli ingest` in "
          f"{cli_s:.1f} s equal; wall s by step {json.dumps(timings)}; ingest "
          f"{timings['ingest']:.2f} s; download {out['download_mb_per_s']:.1f} MB/s "
          f"({n_bytes:,} bytes in {seconds:.4f} s of the client's _download calls); K1 "
          f"{per_step['train'].get('fused_adam', 0)} and its first pass "
          f"{per_step['train'].get('fused_adam_tiles', 0)} over {steps} steps; phase "
          f"{out['wall_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return out


def _timed_phase(label: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), its host seconds printed under the phase's label."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"[chip_smoke] phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    card = _timed_phase("1", phase_device)
    import torch

    from anime_recommendations_tpu_torch.ops import _kernels

    rows = _timed_phase("2", phase_kernels, card)
    new_rows = _timed_phase("2 (K2q, K3, K4)", phase_new_kernels, card)
    _kernels.launches.clear()
    _timed_phase("3", phase_slice, card)
    serving_launches = dict(_kernels.launches)
    print(f"[phase 3] launches on the serving path: {json.dumps(serving_launches)}", flush=True)
    for name in (*K2_COUNTERS, *INT8_COUNTERS, "exact_topk"):
        if serving_launches.get(name, 0) < 1:
            raise AssertionError(f"the serving path never launched {name}")
    if serving_launches.get("l2_normalize", 0) != 2 * len(CONTEXTS):
        raise AssertionError("the context builds did not launch l2_normalize twice each")
    _timed_phase("14", phase_scan_graph, card)
    adam_rows, gather_rows = _timed_phase("4", phase_adam, card)
    dense_adam_rows = _timed_phase("4b", phase_dense_adam, card)
    lazy_adam_row = _timed_phase("4c", phase_lazy_adam, card)
    # 7a's timed dense cases here, beside phase 4's: after phase 6, sessions
    # of torch.profiler lose a few records of every kernel in this process.
    dense_rows = _timed_phase("7a", phase_dense, card, receipts=False)
    _kernels.launches.clear()
    trained = _timed_phase("5", phase_train, card)
    if _kernels.launches["fused_adam"] < 1:
        raise AssertionError("the training path never launched fused_adam")
    graph = _timed_phase("13", phase_graph, card)
    # The one-device epoch's timing, beside which phases 7 and 10 print theirs.
    trained["timed"] = {opt: graph[opt]["captured"] for opt in OPTIMIZERS}
    _timed_phase("15", phase_step_graph, card)   # resets the counters before each run
    gathered = _timed_phase("6", phase_gather, card)   # resets the counters before each epoch
    _timed_phase("6 (convergence)", phase_convergence, card)
    import torch.distributed as dist

    init_nccl()
    try:
        dense_rows += _timed_phase("7a (receipts)", phase_dense, card, receipts=True)
        # resets the counters before each run
        routed = _timed_phase("7b", phase_routed, card, trained)
        _timed_phase("15b", phase_step_graph_sharded, card)   # resets them too
        _timed_phase("10", phase_psum, card, trained)
    finally:
        dist.destroy_process_group()
    _timed_phase("8", phase_trained, card)
    _timed_phase("9", phase_pipeline, card)
    from anime_recommendations_tpu_torch.ops import scan_graph
    from anime_recommendations_tpu_torch.train import device_loop as dl
    from anime_recommendations_tpu_torch.train import step_graph

    dl.release_graphs()        # their memory pools
    scan_graph.release_graphs()
    step_graph.release_graphs()
    torch.cuda.empty_cache()   # the bench's process shares the card
    _timed_phase("11", phase_bench, card)
    _timed_phase("12", phase_download, card)
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
    # K2q's two kernels: dp4a (one query; users int8 Q=1) and the int8
    # tensor cores (more; users int8 Q=256).
    int8_rows = new_rows["packed_topk_int8"]
    for name, branch, case in (("packed_topk_int8", "small_q", "users_int8_q1_exclude"),
                               ("packed_topk_int8_mma", "tensor_core", "users_int8_q256_exclude")):
        ref = next(r for r in int8_rows if r["case"] == case)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "anime_recommendations_tpu_torch/csrc/packed_topk_int8.cu",
            "replaces": "anime_recommendations_tpu/ops/topk.py:219",
            "launches": serving_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in int8_rows if r["branch"] == branch),
            "ms": ref["ms"],
            "plain_ms": ref["plain_ms"],
            "bound_ms": ref["bound_ms"],
            "bound_by": ref["bound_by"],
            "library_ms": None,   # no single PyTorch call makes int8 stage-1 candidates
        })
    for name, case, replaces in (
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
    adam_step = next(r for r in dense_adam_rows if r["case"] == "adam_step")
    kernels.append({
        "name": "dense_adam",
        "route": "cuda",
        "source": "anime_recommendations_tpu_torch/csrc/dense_adam.cu",
        "replaces": None,   # no Pallas kernel: the JAX package leaves it to optax and XLA
        "launches": trained["dense_adam_launches"]["adam"],
        "max_abs_err": 0.0,   # bit for bit the plain chain
        "ms": adam_step["ms"],
        "plain_ms": adam_step["plain_ms"],
        "bound_ms": adam_step["bound_ms"],
        "bound_by": adam_step["bound_by"],
        # The Adam math over a list of tensors: no single call.
        "library_ms": None,
    })
    kernels.append({
        "name": "lazy_adam",
        "route": "cuda",
        "source": "anime_recommendations_tpu_torch/csrc/lazy_adam.cu",
        "replaces": None,   # no Pallas kernel: the JAX package leaves it to XLA
        "launches": trained["lazy_adam_launches"]["lazy_adam"],
        "max_abs_err": max(v for k, v in lazy_adam_row.items() if k.endswith("max_abs_err")),
        "ms": lazy_adam_row["ms"],
        "plain_ms": lazy_adam_row["plain_ms"],
        "bound_ms": lazy_adam_row["bound_ms"],
        "bound_by": lazy_adam_row["bound_by"],
        # Segment sums of sorted runs, then the Adam math on their rows: no single call.
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
