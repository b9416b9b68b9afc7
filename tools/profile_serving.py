#!/usr/bin/env python3
"""Where the serving time goes, on one CUDA card: the numbers of PERF.md section 5.

    python3 tools/profile_serving.py

Needs one CUDA card and nvcc (it builds the kernels as chip_smoke.py does).
Prints JSON lines:

  [stage1]  stage-1 kernel and plain-version time over the 91,641 x 128 user
            table, f32 and bf16, 1 to 256 queries, top_r 4. "warm": launches
            back to back, the table in L2. "cold": each launch after a 256 MB
            write that evicts L2. CUDA events, median of 20 after 3 warm-up.
  [serve]   per endpoint of the in-process Engine (cache off, f32 context at
            reference scale, data and parameters as chip_smoke.py phase 3),
            its scans eager (RecContext.scan_graphs = ScanGraphs(0)) and
            replayed (the context's own cache; the 3 warm-up requests
            capture), side by side: 10 requests after 3 warm-up, under
            torch.profiler. wall_ms_per_req is the host clock around the
            10; scan_ms_per_req the host clock around each _dispatch_topk
            call (cosine_topk's and score_topk's) with a sync on both sides;
            replayed_share the share of those scans a replay served;
            device_busy_ms_per_req the sum of the CUDA kernels' self time;
            device_idle_share = 1 - busy / wall.
  [http]    similar_users through the Engine in process and through the HTTP
            server (urllib, one connection per request) on the same users:
            median ms of 10 after 3 warm-up each.
"""

from __future__ import annotations

import json
import statistics
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def _median_ms(fn, flush=None) -> float:
    import torch

    times = []
    for r in range(23):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if r >= 3:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def stage1(card: str) -> None:
    import torch

    from anime_recommendations_tpu_torch.ops import topk

    dev = torch.device("cuda")
    users = cs._normal_table(np.random.default_rng(1), cs.N_USERS, torch.float32, dev)
    flush = torch.empty(256 * 1024 * 1024 // 4, device=dev)
    for q in (1, 8, 64, 256):
        exclude = torch.arange(q, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            args = (users.to(dtype), users[:q].to(dtype).contiguous(), 4, None, exclude, None)
            row = {"card": card, "q": q, "dtype": str(dtype)}
            for temp, fl in (("warm", None), ("cold", flush)):
                row[f"kernel_ms_{temp}"] = _median_ms(
                    lambda: topk._packed_candidates_cuda(*args), fl)
                row[f"plain_ms_{temp}"] = _median_ms(
                    lambda: topk._packed_candidates_plain(*args), fl)
            print("[stage1] " + json.dumps(row), flush=True)


def serving(card: str) -> None:
    import torch

    from anime_recommendations_tpu_torch.config import Config
    from anime_recommendations_tpu_torch.ops import scan_graph, scoring, topk
    from anime_recommendations_tpu_torch.pipeline.runner import context_from_store, store_root
    from anime_recommendations_tpu_torch.serve.api import Engine, make_server

    scan = {"ms": 0.0, "calls": 0}
    inner = topk._dispatch_topk

    def timed_dispatch(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        scan["ms"] += (time.perf_counter() - t0) * 1e3
        scan["calls"] += 1
        return out

    topk._dispatch_topk = scoring._dispatch_topk = timed_dispatch
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config()
        cs._write_store(store_root(cfg, tmp))
        ctx = context_from_store(cfg, tmp, device="cuda")
        eng = Engine(ctx, cfg, cache_size=0)
        rng = np.random.default_rng(3)
        uids = [int(u) for u in rng.choice(ctx.vocab.user_ids, 400, replace=False)]
        name_of = dict(zip(ctx.catalog.anime["anime_id"], ctx.catalog.anime["Name"]))
        names = [str(name_of[int(a)])
                 for a in rng.choice(ctx.vocab.anime_ids, 40, replace=False)]
        calls = {
            "similar_anime": lambda i: eng.similar_anime(names[i], k=10),
            "similar_users": lambda i: eng.similar_users(uids[i], k=10),
            "user_recs": lambda i: eng.user_recs(uids[i], k=10),
            "model_recs": lambda i: eng.model_recs(uids[i], k=10),
            "similar_anime_batch_q8": lambda i: eng.similar_anime_batch(
                names[8 * (i % 4):8 * (i % 4) + 8], k=10),
            "model_recs_batch_q64": lambda i: eng.model_recs_batch(
                uids[64 * (i % 5):64 * (i % 5) + 64], k=10),
            "similar_users_batch_q256_nofaves": lambda i: eng.similar_users_batch(
                uids[i:i + 256], k=10, include_faves=False),
        }
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        n = 10
        graphs = ctx.scan_graphs
        for endpoint, fn in calls.items():
            row = {"card": card, "endpoint": endpoint}
            for mode, cache in (("eager", scan_graph.ScanGraphs(0)), ("replayed", graphs)):
                ctx.scan_graphs = cache
                for i in range(3):
                    fn(i)
                torch.cuda.synchronize()
                scan.update(ms=0.0, calls=0)
                hits = cache.hits
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    for i in range(3, 3 + n):
                        fn(i)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                events = [e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA]
                busy = sum(e.self_device_time_total for e in events) / 1e3
                top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
                row[mode] = {
                    "wall_ms_per_req": wall / n,
                    "scan_ms_per_req": scan["ms"] / n if scan["calls"] else None,
                    "replayed_share": (cache.hits - hits) / scan["calls"] if scan["calls"]
                    else None,
                    "device_busy_ms_per_req": busy / n, "device_idle_share": 1 - busy / wall,
                    "top_device_ms_per_req": [(e.key[:60], e.self_device_time_total / 1e3 / n)
                                              for e in top],
                }
            print("[serve] " + json.dumps(row), flush=True)
        topk._dispatch_topk = scoring._dispatch_topk = inner
        ctx.scan_graphs = graphs

        server = make_server(ctx, cfg, host="127.0.0.1", port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def http(uid):
            with urllib.request.urlopen(f"{base}/similar_users?user_id={uid}&k=10",
                                        timeout=60) as resp:
                return json.loads(resp.read())

        def median_host_ms(fn):
            times = []
            for i in range(13):
                t0 = time.perf_counter()
                fn(uids[100 + i])
                if i >= 3:
                    times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        try:
            row = {"card": card, "endpoint": "similar_users",
                   "in_process_ms": median_host_ms(lambda u: eng.similar_users(u, k=10)),
                   "http_ms": median_host_ms(http)}
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        print("[http] " + json.dumps(row), flush=True)


def main() -> int:
    card = cs.phase_device()
    stage1(card)
    import torch

    torch.cuda.empty_cache()
    serving(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
