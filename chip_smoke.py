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
           oracle, and timed (CUDA events, median of 20 runs after warm-up;
           for K2q, K3 and K4 also the kernel's device time under
           torch.profiler against its plain version's, and bytes / time
           against 3.35 TB/s):
             packed_topk (K2), f32 and bf16 tables, a k deep enough to
               drive top_r above 64;
             packed_topk_int8 (K2q), int8 tables, keys bit-equal to the
               plain version's without a head, a k that drives top_r above
               64;
             exact_topk (K3), f32 and bf16 tables, k = 10 and 600;
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
           (packed_topk, packed_topk_int8 or exact_topk), and every context
           build l2_normalize twice (the anime and the user table).
  phase 4  the fused sparse-Adam kernel against its plain PyTorch version on
           the card at the training shapes: the 91,641 x 128 user table and
           the 17,560 x 128 anime table (neither a multiple of the 32-row
           block), a 10,000-row batch of the synthetic ratings' ids (their
           real skew), a case with every id the same, f32 moments and bf16
           moments with stochastic rounding. Rows the batch hits at most once
           must match bit for bit (W', mu', nu'), hot rows within the stated
           tolerances, and the bf16 stores must round the other way than
           round-to-nearest about a quarter of the time. The kernel's device
           time and its plain version's (torch.profiler, 20 calls after
           warm-up), bytes moved / time against 3.35 TB/s, and each call's
           CUDA-event time.
  phase 5  training end to end at full width: PipelineRunner.step_train on
           phase 3's store, 2 epochs of 297 batches of 10,000 rows, once per
           optimizer (adam, fused_adam, fused_adam_bf16m; one seed, the
           device loop). Launch counters are reset before it: each fused step
           must launch the kernel twice. The fused histories must track the
           dense one, the bf16m state must hold bf16 table moments, and the
           trained store must serve every endpoint through the HTTP server
           in agreement with the dense oracle. Then one more timed epoch per
           optimizer gives ms per step and examples per second, and 10 steps
           under torch.profiler the device-busy time; the idle share is
           given under the profiler and against the timed epoch's ms/step.

The last lines are the card line, a JSON line of kernel results, and
{"ok": true, "device": {...}}.
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
BATCH = 10_000
TRAIN_EPOCHS = 2


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
    names = list(_kernels.SIGNATURES)
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc process per source
        list(pool.map(_kernels.build, names))
    for name in names:
        _kernels.library(name)
    print(f"[phase 1] built and loaded {', '.join(names)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # torch.profiler's device tracing is set up here, before the HTTP
    # server's threads have launched work: set up first after phase 3, it
    # recorded no kernels in this script.
    if not _profiled(lambda: torch.ones(1 << 20, device="cuda").sum(), reps=1)["device_ms"] > 0:
        raise AssertionError("torch.profiler records no device time on this machine")
    return card


# ---- phase 2 -------------------------------------------------------------------

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


def _profiled(fn, reps: int = TIMED_RUNS, match: str | None = None) -> dict:
    """torch.profiler over ``reps`` calls of fn after 3 warm-up calls: wall ms
    per call (host clock to a synchronize), device-busy ms per call (the sum
    of CUDA kernel times), the idle share, device ms per call by kernel, and
    (``match``) the device ms per call of the kernels whose name holds it."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # A profiler session now and then records no device activity at all
    # (seen once in ~90 sessions on an H100 host): profile again, at most
    # twice.
    # A session that records other kernels but not ``match`` still fails.
    for attempt in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        if events:
            break
        print(f"[profiler] session {attempt + 1} recorded no device activity", flush=True)
    else:
        raise AssertionError("torch.profiler recorded no device activity in 3 sessions")
    busy = sum(e.self_device_time_total for e in events) / 1e3 / reps
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    out = {"wall_ms": wall, "device_ms": busy, "idle_share": 1 - busy / wall,
           "by_kernel": {e.key[:70]: e.self_device_time_total / 1e3 / reps for e in top[:8]}}
    if match is not None:
        out["match_ms"] = sum(e.self_device_time_total for e in events if match in e.key) / 1e3 / reps
        if not out["match_ms"] > 0:
            raise AssertionError(f"the profiler saw no {match} time: {out}")
    return out


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
    before = _kernels.launches["packed_topk"]
    v, i = topk.masked_topk(table, queries, k, mask=mask, exclude=exclude, head=head)
    torch.cuda.synchronize()
    if _kernels.launches["packed_topk"] <= before:
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
    # Stage 1 alone: the kernel's keys against the plain keys.
    args = (table, qt, r, mask, exclude, head)
    kk = topk._packed_candidates_cuda(*args)
    kp = topk._packed_candidates_plain(*args)
    live = (kk > 0) & (kp > 0)
    key_err = float((_decoded(kk) - _decoded(kp)).abs()[live].max())
    if not key_err <= 1e-3:
        raise AssertionError(f"{name}: stage-1 keys differ by {key_err}")
    ms = _median_ms(lambda: topk._packed_candidates_cuda(*args))
    plain_ms = _median_ms(lambda: topk._packed_candidates_plain(*args))
    full_ms = _median_ms(lambda: topk.masked_topk(table, queries, k, mask=mask,
                                                  exclude=exclude, head=head))
    full_plain_ms = _median_ms(lambda: topk.two_stage_topk(
        topk._packed_candidates_plain, table, queries, k, mask=mask, exclude=exclude,
        head=head))
    row = dict(card=card, case=name, n=table.shape[0], q=queries.shape[0], dtype=str(table.dtype),
               k=k, top_r=r, max_abs_err=err, key_err=key_err, overlap=overlap,
               stage1_ms=ms, stage1_plain_ms=plain_ms, masked_topk_ms=full_ms,
               masked_topk_plain_ms=full_plain_ms)
    print("[phase 2] " + json.dumps(row), flush=True)
    return row


def phase_kernels(card: str) -> list[dict]:
    import torch

    from anime_recommendations_tpu_torch.ops import topk

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    users = _normal_table(rng, N_USERS, torch.float32, dev)
    anime = _normal_table(rng, N_ANIME, torch.float32, dev)
    head = torch.tensor([4.3, -0.7], device=dev)
    anime_mask = torch.from_numpy(rng.uniform(size=N_ANIME) > 0.2).to(dev)

    def pick(n, q):
        return torch.from_numpy(rng.choice(n, size=q, replace=False)).to(dev)

    rows = []
    for q in (1, 8, 256):
        idx = pick(N_USERS, q)
        rows.append(_check_case(card, f"users_f32_q{q}_exclude", users, users[idx], 10,
                                exclude=idx))
    # The depth comes from ops/topk.top_r_policy (4 on this table at k = 10),
    # where the JAX package takes 2 above 64 queries: what that depth costs.
    qs = users[idx]
    ms2 = _median_ms(lambda: topk._packed_candidates_cuda(users, qs, 2, None, idx, None))
    print(f"[phase 2] users_f32_q256_exclude stage 1 at top_r=2: {ms2} ms ({card})", flush=True)
    for q in (1, 64):
        rows.append(_check_case(card, f"anime_f32_q{q}_head_mask", anime,
                                users[pick(N_USERS, q)], 10, mask=anime_mask, head=head))
    idx = pick(N_USERS, 1)
    rows.append(_check_case(card, "users_bf16_q1_exclude", users.to(torch.bfloat16),
                            users[idx].to(torch.bfloat16), 10, exclude=idx))
    # model_recs_batch asks for n_recs + max watched; k = 600 drives top_r to 70.
    rows.append(_check_case(card, "anime_f32_q16_head_mask_k600", anime,
                            users[pick(N_USERS, 16)], 600, mask=anime_mask, head=head))
    if max(r["top_r"] for r in rows) <= 64:
        raise AssertionError("no phase-2 case drove top_r above 64")
    return rows


def _timing(fn, plain_fn, kernel: str) -> dict:
    """The kernel's device time per call (torch.profiler, the kernel named
    ``kernel`` alone), its plain version's (all of its kernels), and both
    medians of CUDA-event times (launch overhead included)."""
    return dict(ms=_profiled(fn, match=kernel)["match_ms"],
                plain_ms=_profiled(plain_fn)["device_ms"],
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
    row["bytes_read"] = table.numel() * table.element_size() * -(-queries.shape[0] // 8)
    row["hbm_share"] = row["bytes_read"] / (row["ms"] * 1e-3) / HBM_BYTES_PER_S
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
        out["exact_topk"].append(_exact_case(card, f"users_f32_q{q}_exclude", users, users[idx],
                                             10, exclude=idx))
    for q, k in ((1, 10), (64, 10), (16, 600)):
        qs = users[pick(N_USERS, q)]
        out["packed_topk_int8"].append(_int8_case(card, f"anime_int8_q{q}_head_mask_k{k}", anime_q,
                                                  qs, k, mask=anime_mask, head=head))
        out["exact_topk"].append(_exact_case(card, f"anime_f32_q{q}_head_mask_k{k}", anime, qs, k,
                                             mask=anime_mask, head=head))
    idx = pick(N_USERS, 8)
    out["exact_topk"].append(_exact_case(card, "users_bf16_q8_exclude", users.to(torch.bfloat16),
                                         users[idx], 10, exclude=idx))
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


def _drive_endpoints(ctx, cfg, label, kernel="packed_topk") -> dict:
    """Every endpoint through the HTTP server, checked against the oracle;
    each scanning endpoint must launch ``kernel``. Returns per-endpoint
    median latency (ms, host clock around the request)."""
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
        before = _kernels.launches[kernel]
        t0 = time.perf_counter()
        with urllib.request.urlopen(url, timeout=120) as resp:
            body = json.loads(resp.read())
        latency.setdefault(endpoint, []).append((time.perf_counter() - t0) * 1e3)
        if scans and _kernels.launches[kernel] <= before:
            raise AssertionError(f"{label} /{endpoint}: {kernel} was not launched")
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


# label -> (similarity.retrieval_dtype, RecContext topk_kwargs, the scan kernel)
CONTEXTS = {
    "f32": ("f32", None, "packed_topk"),
    "bf16": ("bf16", None, "packed_topk"),
    "int8": ("int8", None, "packed_topk_int8"),
    "exact_scan": ("f32", {"exact_scan": True}, "exact_topk"),
}


def phase_slice(card: str, device: str = "cuda") -> dict:
    import torch

    from anime_recommendations_tpu_torch.config import Config
    from anime_recommendations_tpu_torch.ops import _kernels
    from anime_recommendations_tpu_torch.pipeline.runner import context_from_store, store_root

    latencies = {}
    with tempfile.TemporaryDirectory() as tmp:
        _write_store(store_root(Config(), tmp))
        for label, (dtype, topk_kwargs, kernel) in CONTEXTS.items():
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
            latencies[label] = _drive_endpoints(ctx, cfg, label, kernel)
            print(f"[phase 3] {label} endpoint latency ms (median, host clock; {card}): "
                  + json.dumps(latencies[label]), flush=True)
            del ctx
    return latencies


# ---- phase 4 -------------------------------------------------------------------

ADAM_STEP, ADAM_LR, ADAM_L2 = 3, 1e-3, 1e-4


def _ulp_bf16(x):
    """One bf16 ulp at each value of x (2^-7 of its binade)."""
    import torch

    _, exponent = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exponent - 8)


def _adam_case(card, name, n, ids_np, dtype, seed):
    import torch

    from anime_recommendations_tpu_torch.ops import _kernels, fused_adam

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    b = ids_np.shape[0]
    w = torch.from_numpy(rng.uniform(-0.05, 0.05, (n, D)).astype(np.float32)).to(dev)
    mu = torch.from_numpy((rng.standard_normal((n, D)) * 1e-3).astype(np.float32)).to(dev, dtype)
    nu = torch.from_numpy(((rng.standard_normal((n, D)) * 1e-3) ** 2).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy((rng.standard_normal((b, D)) * 1e-3).astype(np.float32)).to(dev)
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
    sr = dtype == torch.bfloat16
    plain_in = [x.clone() for x in (w, mu, nu)]   # the inputs, kept as they were
    plain = [x.clone() for x in plain_in]
    order = torch.argsort(ids, stable=True)
    ids_s, g_s = ids[order], g[order]
    scal = fused_adam.adam_scalars(ADAM_STEP, ADAM_LR, ADAM_L2, 0.9, 0.999, 1e-7)

    before = _kernels.launches["fused_adam"]
    got = fused_adam.sparse_adam_update(w, mu, nu, ids, g, ADAM_STEP, ADAM_LR, l2=ADAM_L2)
    if _kernels.launches["fused_adam"] != before + 1:
        raise AssertionError(f"{name}: sparse_adam_update did not launch the kernel")
    want = fused_adam._sparse_adam_update_plain(*plain, ids_s, g_s, scal, ADAM_STEP, sr)
    torch.cuda.synchronize()
    row = dict(card=card, case=name, n=n, n_mod_block=n % fused_adam.BLOCK_ROWS, batch=b,
               distinct_ids=int(np.unique(ids_np).size), moments=str(dtype), sr=sr)
    # A row the batch hits at most once has no summation order to differ in:
    # W', mu' and nu' must equal the plain version's bit for bit there, which
    # pins the stochastic rounding's bits (any other rounding or hash lands
    # on the other bf16 neighbour for a share of the elements). Hot rows sum
    # in another order than index_add_'s atomics: the tolerances below.
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
        if label != "w" and sr:
            if bool((diff > _ulp_bf16(c32)).any()):
                raise AssertionError(f"{name}: {label}' differs by more than one bf16 ulp")
        elif not row[f"{label}_err_vs_scale"] <= 1e-5:
            raise AssertionError(f"{name}: {label}' differs from the plain version by "
                                 f"{row[f'{label}_err_vs_scale']} of its scale")
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

    # ms: the kernel's own device time (torch.profiler); plain_ms: the device
    # time of all of the plain version's kernels. The CUDA-event times are
    # what one call costs its caller on this host, launch overhead included.
    m_bytes = 2 if sr else 4
    moved = 2 * n * D * 4 + 4 * n * D * m_bytes + b * D * 4 + b * 4
    prof = _profiled(lambda: fused_adam._sparse_adam_update_cuda(
        w, mu, nu, ids_s, g_s, scal, ADAM_STEP, sr))
    row["ms"] = sum(v for k, v in prof["by_kernel"].items() if "fused_adam_kernel" in k)
    row["prep_device_ms"] = prof["device_ms"] - row["ms"]
    row["plain_ms"] = _profiled(lambda: fused_adam._sparse_adam_update_plain(
        *plain, ids_s, g_s, scal, ADAM_STEP, sr))["device_ms"]
    row["event_ms"] = _median_ms(lambda: fused_adam._sparse_adam_update_cuda(
        w, mu, nu, ids_s, g_s, scal, ADAM_STEP, sr))
    row["plain_event_ms"] = _median_ms(lambda: fused_adam._sparse_adam_update_plain(
        *plain, ids_s, g_s, scal, ADAM_STEP, sr))
    row["with_sort_event_ms"] = _median_ms(lambda: fused_adam.sparse_adam_update(
        w, mu, nu, ids, g, ADAM_STEP, ADAM_LR, l2=ADAM_L2))
    if not row["ms"] > 0:
        raise AssertionError(f"{name}: the profiler saw no fused_adam_kernel time: {prof}")
    row["bytes_moved"] = moved
    row["hbm_share"] = moved / (row["ms"] * 1e-3) / HBM_BYTES_PER_S
    row["plain_hbm_share"] = moved / (row["plain_ms"] * 1e-3) / HBM_BYTES_PER_S
    print("[phase 4] " + json.dumps(row), flush=True)
    return row


def phase_adam(card: str) -> list[dict]:
    import torch

    train, _ = _train_split()
    users, anime = train.users[:BATCH], train.anime[:BATCH]
    hot_user = np.bincount(users).argmax()
    rows = []
    for i, (name, n, ids, dtype) in enumerate((
        ("users_f32", N_USERS, users, torch.float32),
        ("anime_f32", N_ANIME, anime, torch.float32),
        ("users_bf16_sr", N_USERS, users, torch.bfloat16),
        ("anime_bf16_sr", N_ANIME, anime, torch.bfloat16),
        ("users_f32_one_id", N_USERS, np.full(BATCH, hot_user), torch.float32),
        ("users_bf16_sr_one_id", N_USERS, np.full(BATCH, hot_user), torch.bfloat16),
    )):
        rows.append(_adam_case(card, name, n, ids, dtype, SEED + i))
    return rows


# ---- phase 5 -------------------------------------------------------------------

OPTIMIZERS = ("adam", "fused_adam", "fused_adam_bf16m")


def _timed_epoch(optimizer: str) -> dict:
    """One more epoch of the device loop from a fresh state, timed with the
    host clock between two synchronizes."""
    import torch

    from anime_recommendations_tpu_torch.train import device_loop as dl
    from anime_recommendations_tpu_torch.train import trainer as tr

    train, _ = _train_split()
    _, vocab, _, _ = _dataset()
    state = tr.init_train_state(vocab.n_users, vocab.n_anime, D,
                                generator=torch.Generator().manual_seed(SEED), device="cuda")
    if optimizer == "fused_adam_bf16m":
        state = tr.cast_table_moments(state, torch.bfloat16)
    data = dl.stage(train, BATCH, seed=SEED, device="cuda")
    steps = data.n // BATCH
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, losses, _, _ = dl.train_epoch(state, data, torch.Generator().manual_seed(SEED), 1e-5,
                                     BATCH, 1e-4, optimizer=optimizer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{optimizer}: non-finite loss in the timed epoch")
    # Where a step's time goes: 10 steps (the first 10 batches, unshuffled)
    # under torch.profiler, per step.
    window = dl.DeviceData(*(x[:10 * BATCH] for x in data))
    prof = _profiled(lambda: dl.train_epoch(state, window, None, 1e-5, BATCH, 1e-4,
                                            shuffle=False, optimizer=optimizer), reps=1)
    per_step = {"wall_ms": prof["wall_ms"] / 10, "device_ms": prof["device_ms"] / 10,
                "by_kernel": {k: v / 10 for k, v in prof["by_kernel"].items()}}
    ms_per_step = seconds * 1e3 / steps
    # The profiler slows the host, so the idle share under it overstates the
    # timed epoch's: both are given, the second from the unprofiled ms/step.
    return dict(steps=steps, ms_per_step=ms_per_step,
                examples_per_sec=len(train) / seconds, profiled_step=per_step,
                idle_share_profiled=prof["idle_share"],
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
            runner = PipelineRunner(cfg, tmp, device="cuda")
            before = _kernels.launches["fused_adam"]
            t0 = time.perf_counter()
            result = runner.step_train()
            torch.cuda.synchronize()
            out["train_seconds"][optimizer] = time.perf_counter() - t0
            launched = _kernels.launches["fused_adam"] - before
            steps = steps_per_epoch * result.epochs_run
            want = 0 if optimizer == "adam" else 2 * steps
            if launched != want:
                raise AssertionError(f"{optimizer}: {launched} fused_adam launches for "
                                     f"{steps} steps, expected {want}")
            out["launches"][optimizer] = launched
            hist = result.history
            if len(hist) != TRAIN_EPOCHS or not np.isfinite(hist.to_numpy()).all():
                raise AssertionError(f"{optimizer}: history {hist.to_dict('list')}")
            if optimizer == "fused_adam_bf16m":
                moments = result.state.adam
                if {moments.mu[k].dtype for k in ("user_emb", "anime_emb")} | {
                        moments.nu[k].dtype for k in ("user_emb", "anime_emb")} != {torch.bfloat16}:
                    raise AssertionError("fused_adam_bf16m: table moments are not bf16")
            out["history"][optimizer] = hist
            print(f"[phase 5] {optimizer}: {launched} fused_adam launches over {steps} steps, "
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
        before = _kernels.launches["packed_topk"]
        out["serving_ms"] = _drive_endpoints(ctx, cfg, "trained")
        out["serving_launches"] = _kernels.launches["packed_topk"] - before
        print(f"[phase 5] trained store served every endpoint in agreement with the dense "
              f"oracle (overlap 1.0); latency ms ({card}): {json.dumps(out['serving_ms'])}",
              flush=True)
    out["timed"] = {}
    for optimizer in OPTIMIZERS:
        out["timed"][optimizer] = _timed_epoch(optimizer)
        print(f"[phase 5] {optimizer} timed epoch ({card}): "
              f"{json.dumps(out['timed'][optimizer])}", flush=True)
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
    for name in ("packed_topk", "packed_topk_int8", "exact_topk"):
        if serving_launches.get(name, 0) < 1:
            raise AssertionError(f"the serving path never launched {name}")
    if serving_launches.get("l2_normalize", 0) != 2 * len(CONTEXTS):
        raise AssertionError("the context builds did not launch l2_normalize twice each")
    adam_rows = phase_adam(card)
    _kernels.launches.clear()
    trained = phase_train(card)
    if _kernels.launches["fused_adam"] < 1:
        raise AssertionError("the training path never launched fused_adam")
    ref = next(r for r in rows if r["case"] == "users_f32_q1_exclude")
    kernels = [{
        "name": "packed_topk",
        "route": "cuda",
        "source": "anime_recommendations_tpu_torch/csrc/packed_topk.cu",
        "replaces": "anime_recommendations_tpu/ops/topk.py:185",
        "launches": serving_launches["packed_topk"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": ref["stage1_ms"],
        "plain_ms": ref["stage1_plain_ms"],
    }]
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
        })
    for label, optimizer, sr in (("f32 moments", "fused_adam", False),
                                 ("bf16 moments, stochastic rounding", "fused_adam_bf16m", True)):
        cases = [r for r in adam_rows if r["sr"] == sr]
        users = next(r for r in cases if r["case"].startswith("users") and "one_id" not in r["case"])
        kernels.append({
            "name": f"fused_adam ({label})",
            "route": "cuda",
            "source": "anime_recommendations_tpu_torch/csrc/fused_adam.cu",
            "replaces": "anime_recommendations_tpu/ops/fused_adam.py:71",
            "launches": trained["launches"][optimizer],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": users["ms"],
            "plain_ms": users["plain_ms"],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
