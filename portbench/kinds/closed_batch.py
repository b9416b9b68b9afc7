"""Batched requests from one closed-loop client, the nightly job over every
user.

Set-up builds the context from the seed and starts the server
(server.py), then warms the routes the mix uses with requests of users the
window does not reach first. The window is the client process's
(client.py): requests alternate over the mix's routes, each with the next
``ids_per_request`` users of a seeded permutation of all users, sent one
after another until ``seconds`` have passed. After it the server stops, the
port's context is freed, and the reference checks a seeded sample of the
answered requests, every answer in each (reference.scores, compare.answer_gap):
the rows and scores as returned, the exclusion of the query user, the
catalog mask and the watched exclusion of model_recs_batch, and the names.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from portbench import client, compare, datagen, reference, work
from portbench.harness import Outcome, checks_of
from portbench.server import Server, Spans, build_context
from portbench.trace import Tracer

WARM_REQUESTS = 2       # of each route, from the permutation's far end


def plan_paths(mix: dict, n_users: int, seed: int) -> tuple[list, list]:
    """(window's paths, warm-up paths): request i takes route i mod the
    routes and the i-th block of a seeded permutation of the users; the
    warm-up takes blocks from the permutation's end."""
    perm = np.random.default_rng(datagen.sub_seeds(seed)[7]).permutation(n_users)
    ids = datagen.user_ids(perm)
    q = mix["ids_per_request"]
    blocks = [ids[i:i + q] for i in range(0, len(ids) - q + 1, q)]
    routes = mix["routes"]

    def path(i: int, block) -> str:
        route = routes[i % len(routes)]
        sep = "&" if "?" in route else "?"
        return f"/{route}{sep}user_ids={','.join(map(str, block))}&k={mix['k']}"

    n_warm = WARM_REQUESTS * len(routes)
    window = [path(i, b) for i, b in enumerate(blocks[:-n_warm])]
    warm = [path(i, b) for i, b in enumerate(blocks[-n_warm:])]
    return window, warm


def scan_work(cfg: dict, inputs, spans: list, k: int) -> float:
    """The least seconds of every scan the spans' requests asked for
    (work.scan): a similar_users_batch request scans the user table, a
    model_recs_batch request the anime table under the catalog mask, for
    k plus the most any of its users watched."""
    total = 0.0
    d = cfg["embedding_size"]
    for method, _, _, args in spans:
        users = [(u - datagen.USER_ID_BASE) // datagen.USER_ID_STRIDE for u in args[0]]
        if method == "similar_users_batch":
            total += work.scan(cfg["n_users"], d, len(users), k).least_seconds()
        elif method == "model_recs_batch":
            kk = min(k + max(len(inputs.watched(u)) for u in users), cfg["n_anime"])
            total += work.scan(cfg["n_anime"], d, len(users), kk, mask=True,
                               head=True).least_seconds()
    return total


def check_answers(cfg: dict, seed: int, inputs, sample: list, k: int, device) -> dict:
    """The check's numbers over the sampled answered requests: the widest
    gap of an answer (compare.answer_gap) and the count of wrong answers
    (a row it may not hold, a wrong name, a missing query)."""
    w = datagen.weights(cfg, seed, device)
    user_n, anime_n = reference.normalize(w["user_emb"]), reference.normalize(w["anime_emb"])
    head = reference.head_affine(w)
    del w
    present = (inputs.catalog["MAL_ID"].to_numpy() - datagen.ANIME_ID_BASE) // datagen.ANIME_ID_STRIDE
    in_catalog = torch.zeros(cfg["n_anime"], dtype=torch.bool, device=device)
    in_catalog[torch.as_tensor(present, device=device)] = True
    names = dict(zip(inputs.catalog["MAL_ID"].tolist(), inputs.catalog["Name"].tolist()))
    gap, wrong, worst = 0.0, 0, None
    for path, body in sample:
        route = path[1:].split("?")[0]
        records = json.loads(body)
        asked = [int(u) for u in path.split("user_ids=")[1].split("&")[0].split(",")]
        rows = [(u - datagen.USER_ID_BASE) // datagen.USER_ID_STRIDE for u in asked]
        q = user_n[torch.as_tensor(rows, device=device)]
        if route == "similar_users_batch":
            ref = reference.scores(user_n, q)
        else:
            ref = reference.scores(anime_n, q, head)
        if len(records) != len(asked):
            wrong += len(asked)
            continue
        for i, (rec, row) in enumerate(zip(records, rows)):
            if route == "similar_users_batch":
                live = torch.ones(cfg["n_users"], dtype=torch.bool, device=device)
                live[row] = False
                ok = rec["query"] == asked[i]
                got = (np.asarray(rec["similar_users"], np.int64) - datagen.USER_ID_BASE) // datagen.USER_ID_STRIDE
                served = rec["similarities"]
            else:
                live = in_catalog.clone()
                live[torch.as_tensor(inputs.watched(row), dtype=torch.long, device=device)] = False
                ids = rec["anime_ids"]
                ok = rec["user_id"] == asked[i] and rec["names"] == [names.get(a) for a in ids]
                got = (np.asarray(ids, np.int64) - datagen.ANIME_ID_BASE) // datagen.ANIME_ID_STRIDE
                served = rec["predictions"]
            g = compare.answer_gap(got, np.asarray(served), ref[i], live, k) if ok else math.inf
            if math.isinf(g):
                wrong += 1
                print(f"[portbench] wrong answer: {route} user {asked[i]}: {str(rec)[:600]}",
                      flush=True)
            elif g > gap:
                gap, worst = g, (route, asked[i])
    print(f"[portbench] widest gap {gap!r}: {worst}", flush=True)
    return {"score_gap": gap, "wrong_answers": float(wrong)}


def sample_requests(records: list, bodies: list, window: list, seed: int, n: int) -> list:
    """A seeded sample of ``n`` answered requests of each route."""
    rng = np.random.default_rng(datagen.sub_seeds(seed, 9)[8])
    by_route: dict = {}
    for (i, *_rest, status), body in zip(records, bodies):
        if status == 200:
            by_route.setdefault(window[i % len(window)][1:].split("?")[0], []).append(
                (window[i % len(window)], body))
    out = []
    for reqs in by_route.values():
        pick = rng.choice(len(reqs), size=min(n, len(reqs)), replace=False)
        out += [reqs[j] for j in sorted(pick)]
    return out


def measure(cell, device, clock, retrieval_dtype=None) -> tuple[dict, dict]:
    """Set-up, the window and the check; returns (raw results, numbers)."""
    cfg, mix, seed = cell.config, cell.traffic, cell.seed
    ctx, inputs = build_context(cfg, seed, device, clock, retrieval_dtype)
    clock.mark("context")
    window, warm = plan_paths(mix, cfg["n_users"], seed)
    spans = Spans()
    with Server(ctx, spans) as srv:
        for path in warm:
            status, body = client.fetch(srv.port, path)
            if status != 200:
                raise RuntimeError(f"warm-up request failed ({status}): {body[:500]}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        clock.mark("warm_up")
        spans.records.clear()
        graphs0 = dict(ctx.scan_graphs.report())
        plan = {"port": srv.port, "paths": window, "seconds": cell.seconds}
        tracer = Tracer(device) if cell.trace else None
        if tracer:
            tracer.__enter__()
        result = client.run(plan)
        if tracer:
            tracer.__exit__(None, None, None)
        graphs1 = dict(ctx.scan_graphs.report())
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ctx.release_graphs()
    del ctx
    if device.type == "cuda":
        torch.cuda.empty_cache()
    records, bodies = result["records"], result["bodies"]
    sample = sample_requests(records, bodies, window, seed, mix["sample_requests"])
    numbers = check_answers(cfg, seed, inputs, sample, mix["k"], device)
    answered = [r for r in records if r[3] == 200]
    raw = {"start": result["start"], "end": result["end"], "records": records,
           "answered": answered, "spans": list(spans.records), "graphs0": graphs0,
           "graphs1": graphs1, "peak": peak, "tracer": tracer, "inputs": inputs}
    return raw, numbers


def run(cell, device, clock) -> Outcome:
    cfg, mix = cell.config, cell.traffic
    raw, numbers = measure(cell, device, clock)
    window_s = raw["end"] - raw["start"]
    clock.parts["warm_up"] += raw["start"] - (clock.start + clock.setup_s)
    queries = mix["ids_per_request"] * len(raw["answered"])
    g0, g1 = raw["graphs0"], raw["graphs1"]
    calls = (g1["hits"] - g0["hits"]) + (g1["misses"] - g0["misses"])
    readings = {"kind": "batch", "window_s": window_s, "requests": len(raw["records"]),
                "scan_hits": g1["hits"] - g0["hits"], "scan_calls": calls,
                "least_scan_s": scan_work(cfg, raw["inputs"], raw["spans"], mix["k"])}
    tracer = raw["tracer"]
    if tracer:
        t = tracer.trace
        readings.update(device_op_s=t.op_s, busy_s=t.busy_s, traced_window_s=t.window_s,
                        device_ops=t.n_ops)
    failed = len(raw["records"]) - len(raw["answered"])
    engine: dict = {}
    for method, t0, t1, _ in raw["spans"]:
        engine.setdefault(method, []).append(1e3 * (t1 - t0))
    request_ms = [1e3 * r[2] for r in raw["records"]]
    print("[portbench] window " + json.dumps({
        "requests": len(request_ms), "request_mean_ms": float(np.mean(request_ms)),
        "engine_mean_ms": {m: float(np.mean(v)) for m, v in engine.items()}}), flush=True)
    return Outcome(end_to_end={"batch_queries_per_s": queries / window_s},
                   readings=readings, checks=checks_of(numbers, cell.limits),
                   attempted=len(raw["records"]), failed=failed,
                   memory_peak_bytes=raw["peak"], trace=tracer.trace if tracer else None)


def calibrate(cell, device, seed: int, control: bool) -> dict:
    """The control's readings on one seed: the program with its own bf16
    retrieval tables switched on, through a short window at the cell's
    load. The sound program's readings come from the cell's runs."""
    from portbench.harness import Clock

    cell.seed = seed
    out = {}
    if control:
        _, out["control"] = measure(cell, device, Clock(), retrieval_dtype="bf16")
    return out
