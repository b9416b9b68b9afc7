#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; it builds the port's kernels from the
checkout itself. It fails (exit code other than 0, no result line) when
CUDA is unavailable or when it runs outside a checkout of the repository.

  phase 1  device and build: card name and power limit, torch/CUDA/nvcc
           versions, build seconds of every kernel.
  phase 2  each kernel against its plain PyTorch version on the card at the
           shapes the serving path gives it (91,641 x 128 user table,
           17,560 x 128 anime table; f32 and bf16; 1 to 256 queries; with
           and without head, mask and exclude; a k deep enough to drive
           top_r above 64), against a dense full-score oracle, and timed
           (CUDA events, median of 20 runs after warm-up).
  phase 3  the slice end to end at reference scale: synthetic data of
           ~91,641 users x 17,560 anime x 3M ratings made from a seed, D =
           128 parameters from a seed written in the JAX package's .npz
           format and loaded from an artifact store through the port's
           entry points, an f32 and a bf16 context on the card, and every
           endpoint of the HTTP server answered and checked against a dense
           oracle on the card. Launch counters are reset before this phase
           and must show every scanning endpoint going through the kernel.

The last lines are the card line, a JSON line of kernel results, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

N_USERS, N_ANIME, N_RATINGS, D = 91_641, 17_560, 3_000_000, 128
SEED = 7
TIMED_RUNS = 20


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
    for name in _kernels.SIGNATURES:
        t0 = time.perf_counter()
        _kernels.library(name)
        print(f"[phase 1] built and loaded {name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
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


# ---- phase 3 -------------------------------------------------------------------

def _write_store(root: Path) -> None:
    """A run directory in the JAX pipeline's artifact-store layout, holding
    what its ingest, preprocess and train steps write."""
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
    print(f"[phase 3] data: {len(raw)} ratings -> {len(clean)} rows, vocab "
          f"{vocab.n_users} users x {vocab.n_anime} anime, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


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


def _drive_endpoints(ctx, cfg, label) -> dict:
    """Every endpoint through the HTTP server, checked against the oracle.
    Returns per-endpoint median latency (ms, host clock around the request)."""
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
        before = _kernels.launches["packed_topk"]
        t0 = time.perf_counter()
        with urllib.request.urlopen(url, timeout=120) as resp:
            body = json.loads(resp.read())
        latency.setdefault(endpoint, []).append((time.perf_counter() - t0) * 1e3)
        if scans and _kernels.launches["packed_topk"] <= before:
            raise AssertionError(f"{label} /{endpoint}: the kernel was not launched")
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


def phase_slice(card: str, device: str = "cuda") -> dict:
    import torch

    from anime_recommendations_tpu_torch.config import Config
    from anime_recommendations_tpu_torch.pipeline.runner import context_from_store, store_root

    latencies = {}
    with tempfile.TemporaryDirectory() as tmp:
        _write_store(store_root(Config(), tmp))
        for dtype in ("f32", "bf16"):
            cfg = Config().with_overrides([f"similarity.retrieval_dtype={dtype}"])
            t0 = time.perf_counter()
            ctx = context_from_store(cfg, tmp, device=device)
            if ctx.device.type == "cuda":
                torch.cuda.synchronize()
            print(f"[phase 3] {dtype} context built on {ctx.device} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            latencies[dtype] = _drive_endpoints(ctx, cfg, dtype)
            print(f"[phase 3] {dtype} endpoint latency ms (median, host clock; {card}): "
                  + json.dumps(latencies[dtype]), flush=True)
    return latencies


def main() -> int:
    card = phase_device()
    import torch

    from anime_recommendations_tpu_torch.ops import _kernels

    rows = phase_kernels(card)
    _kernels.launches.clear()
    phase_slice(card)
    launches = dict(_kernels.launches)
    if launches.get("packed_topk", 0) < 1:
        raise AssertionError("the serving path never launched packed_topk")
    ref = next(r for r in rows if r["case"] == "users_f32_q1_exclude")
    kernels = [{
        "name": "packed_topk",
        "route": "cuda",
        "source": "anime_recommendations_tpu_torch/csrc/packed_topk.cu",
        "replaces": "anime_recommendations_tpu/ops/topk.py:185",
        "launches": launches["packed_topk"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": ref["stage1_ms"],
        "plain_ms": ref["stage1_plain_ms"],
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
