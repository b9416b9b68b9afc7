"""Batched requests from one closed-loop client over a catalog of tens of
millions of rows: the nightly job over every user, tables streamed from HBM.

The window, the client and the check of closed_batch (its helpers, through
harness.kind_module), with what the size changes:

* set-up draws the inputs with datagen_stream.py: the ratings on the card,
  a lean catalog, and the weights as seeded blocks of rows that the port's
  RecContext.build reads in chunks, so that the card never holds a second
  copy of a table (RecContext.tables_report() is printed: the card memory
  the build left, in copies of the tables);
* the window's paths are the first blocks of a seeded permutation of all
  users, as many as the window could reach, and the warm-up sends, before
  the window, two scans of each scan signature the window will meet
  (model_recs_batch's k, rounded up by the port's batch.scan_k): the first
  runs eagerly and the second is captured, so that no graph is captured
  inside the window;
* the check holds every answer of a seeded sample of answered requests
  against reference_blocked.py: exact f32 scores over the whole table, one
  block of rows at a time, never [Q, N];
* the traced window also reads the device time of the kernels that the
  scan graphs' replays ran (matched to their cudaGraphLaunch by the
  profiler's correlation ids) and the scans' work that the port counted
  per replay (ScanGraphs.scan_report()), for scan_kernel_roofline.batch.

A port without one-copy tables, scans past 33,553,920 rows or a scan
counter fails at once, before any input is drawn.
"""

from __future__ import annotations

import gc
import json
import math

import numpy as np
import pandas as pd
import torch

from portbench import client, datagen, datagen_stream, harness, reference, reference_blocked
from portbench.harness import Outcome, checks_of
from portbench.server import Inputs, Server, Spans
from portbench.trace import Tracer, _annotation

base = harness.kind_module("closed_batch")
WARM_PER_SIGNATURE = 2
WINDOW_BLOCKS = 8192          # request paths planned at most; the client takes them in turn
GRAPH_LAUNCH = "cudaGraphLaunch"


def require_port():
    """The port's modules this cell needs, or a RuntimeError naming what
    is missing."""
    from anime_recommendations_tpu_torch.ops import scan_graph, topk
    from anime_recommendations_tpu_torch.recommend import batch, context

    missing = [name for name, ok in (
        ("RecContext.tables_report (one copy of each table)",
         hasattr(context.RecContext, "tables_report")),
        ("ops.topk.MAX_BLOCKS (scans past 33,553,920 rows)", hasattr(topk, "MAX_BLOCKS")),
        ("ScanGraphs.scan_report (the scans' work)", hasattr(scan_graph.ScanGraphs, "scan_report")),
        ("recommend.batch.scan_k (model_recs_batch's k buckets)", hasattr(batch, "scan_k")),
    ) if not ok]
    if missing:
        raise RuntimeError("the port cannot serve this catalog: it lacks " + "; ".join(missing))
    return batch


def build_context(cfg: dict, seed: int, device, clock=None, retrieval_dtype=None):
    """(RecContext, Inputs, SeededModel) from the seed."""
    from anime_recommendations_tpu_torch.data.catalog import Catalog
    from anime_recommendations_tpu_torch.data.vocab import Vocab
    from anime_recommendations_tpu_torch.recommend.context import RecContext

    mark = clock.mark if clock else (lambda name: None)
    r = datagen_stream.ratings(cfg, seed, device)
    users = r.users.to(torch.int32).cpu().numpy()
    anime = r.anime.to(torch.int32).cpu().numpy()
    rating = r.rating.cpu().numpy()
    offsets = r.offsets
    del r
    if device.type == "cuda":
        torch.cuda.empty_cache()
    vocab = Vocab(user_ids=datagen.user_ids(np.arange(cfg["n_users"])),
                  anime_ids=datagen.anime_ids(np.arange(cfg["n_anime"])))
    frame = pd.DataFrame({"user": users, "anime": anime, "rating": rating,
                          "user_id": vocab.user_ids[users], "anime_id": vocab.anime_ids[anime]})
    del users, rating
    mark("data")
    raw_catalog = datagen_stream.catalog_frame(cfg, seed)
    catalog = Catalog.from_frames(raw_catalog, None)
    inputs = Inputs(anime=anime, offsets=offsets, catalog=raw_catalog)
    mark("catalog")
    model = datagen_stream.SeededModel(cfg, seed, device)
    ctx = RecContext.build(model, vocab, catalog, frame, device=device,
                           retrieval_dtype=retrieval_dtype or cfg["retrieval_dtype"])
    model.release()
    return ctx, inputs, model


def plan_paths(mix: dict, n_users: int, seed: int) -> tuple[list, list]:
    """(window's paths, first warm-up paths): closed_batch.plan_paths over
    the first blocks of its seeded permutation of the users, at most
    WINDOW_BLOCKS (the window's), and the last two per route (the
    warm-up's)."""
    perm = np.random.default_rng(datagen.sub_seeds(seed)[7]).permutation(n_users)
    q, routes = mix["ids_per_request"], mix["routes"]
    n_warm = base.WARM_REQUESTS * len(routes)
    n_window = min(WINDOW_BLOCKS, n_users // q - n_warm)
    blocks = [perm[i * q:(i + 1) * q] for i in range(n_window)]
    blocks += [perm[len(perm) - (n_warm - i) * q:len(perm) - (n_warm - i - 1) * q]
               for i in range(n_warm)]
    ids = datagen.user_ids(np.concatenate(blocks))

    def path(i: int, block) -> str:
        route = routes[i % len(routes)]
        sep = "&" if "?" in route else "?"
        return f"/{route}{sep}user_ids={','.join(map(str, block))}&k={mix['k']}"

    window = [path(i, ids[i * q:(i + 1) * q]) for i in range(n_window)]
    warm = [path(i, ids[(n_window + i) * q:(n_window + i + 1) * q]) for i in range(n_warm)]
    return window, warm


def _asked_rows(path: str) -> np.ndarray:
    asked = np.asarray(path.split("user_ids=")[1].split("&")[0].split(","), np.int64)
    return (asked - datagen.USER_ID_BASE) // datagen.USER_ID_STRIDE


def signature_paths(window: list, inputs: Inputs, mix: dict, n_items: int, scan_k) -> list:
    """WARM_PER_SIGNATURE paths of each model_recs_batch scan k (``scan_k``
    of k plus the most any of its users watched) the window's requests ask
    for: that many of the window's paths of the signature, or its one path
    repeated."""
    counts = np.diff(inputs.offsets)
    seen: dict = {}
    for path in window:
        if not path.startswith("/model_recs_batch"):
            continue
        k = scan_k(min(mix["k"] + int(counts[_asked_rows(path)].max()), n_items))
        if len(seen.setdefault(k, [])) < WARM_PER_SIGNATURE:
            seen[k].append(path)
    return [p for paths in seen.values()
            for p in (paths * WARM_PER_SIGNATURE)[:WARM_PER_SIGNATURE]]


def graph_kernel_seconds(tracer: Tracer) -> float | None:
    """The device time of the operations that the traced window's CUDA graph
    replays ran: device events whose correlation id is a cudaGraphLaunch's.
    None where the profiler links none."""
    prof = getattr(tracer, "_prof", None)
    if prof is None:
        return None
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    launches = {e.correlation_id() for e in events
                if e.device_type() != cuda and e.name() == GRAPH_LAUNCH}
    ns = [e.duration_ns() for e in events
          if e.device_type() == cuda and not _annotation(e)
          and (e.correlation_id() in launches or e.linked_correlation_id() in launches)]
    return sum(ns) / 1e9 if ns else None


def measure(cell, device, clock, retrieval_dtype=None) -> tuple[dict, dict]:
    """Set-up, the window and the check; returns (raw results, numbers)."""
    batch = require_port()
    cfg, mix, seed = cell.config, cell.traffic, cell.seed
    ctx, inputs, model = build_context(cfg, seed, device, clock, retrieval_dtype)
    clock.mark("context")
    window, warm = plan_paths(mix, cfg["n_users"], seed)
    warm += signature_paths(window, inputs, mix, cfg["n_anime"], batch.scan_k)
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
        graphs0, work0 = dict(ctx.scan_graphs.report()), ctx.scan_graphs.scan_report()
        plan = {"port": srv.port, "paths": window, "seconds": cell.seconds}
        tracer = Tracer(device) if cell.trace else None
        if tracer:
            tracer.__enter__()
        result = client.run(plan)
        if tracer:
            tracer.__exit__(None, None, None)
        graphs1, work1 = dict(ctx.scan_graphs.report()), ctx.scan_graphs.scan_report()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    tables = ctx.tables_report()
    ctx.release_graphs()
    del ctx, srv
    gc.collect()        # the stopped server's handler class holds the context in a cycle
    if device.type == "cuda":
        torch.cuda.empty_cache()
    records, bodies = result["records"], result["bodies"]
    sample = base.sample_requests(records, bodies, window, seed, mix["sample_requests"])
    numbers = check_answers(cfg, inputs, model, sample, mix["k"], device)
    answered = [r for r in records if r[3] == 200]
    raw = {"start": result["start"], "end": result["end"], "records": records,
           "answered": answered, "spans": list(spans.records), "graphs0": graphs0,
           "graphs1": graphs1, "peak": peak, "tracer": tracer, "inputs": inputs,
           "tables": tables, "sample": sample, "model": model,
           "scan_work": {k: work1[k] - work0[k] for k in work1}}
    return raw, numbers


def table_rows(table, rows: np.ndarray, device) -> torch.Tensor:
    """Rows of a SeededTable (or any [N, D] object read by row ranges), in
    the order given, drawn block by block."""
    rows = np.asarray(rows, np.int64)
    out = torch.empty(len(rows), table.shape[1], device=device)
    step = datagen_stream.BLOCK_ROWS
    for b in np.unique(rows // step):
        at = np.flatnonzero(rows // step == b)
        block = table[b * step:min((b + 1) * step, table.shape[0])].to(device)
        out[torch.as_tensor(at, device=device)] = block[torch.as_tensor(rows[at] - b * step,
                                                                       device=device)]
    return out


def served(records: list, asked: list, route: str) -> tuple[list, list, list]:
    """Per query of a route's sampled answers: (rows served, scores served,
    the answer's own fields as the check wants them: None where they are
    wrong). Rows are logical rows of the scanned table."""
    rows, scores, ok = [], [], []
    for rec, uid in zip(records, asked):
        if route == "similar_users_batch":
            ids, vals = rec["similar_users"], rec["similarities"]
            rows.append((np.asarray(ids, np.int64) - datagen.USER_ID_BASE)
                        // datagen.USER_ID_STRIDE)
            ok.append(rec["query"] == uid)
        else:
            ids, vals = rec["anime_ids"], rec["predictions"]
            rows.append((np.asarray(ids, np.int64) - datagen.ANIME_ID_BASE)
                        // datagen.ANIME_ID_STRIDE)
            ok.append(rec["user_id"] == uid)
        scores.append(np.asarray(vals, np.float64))
    return rows, scores, ok


def names_match(catalog: pd.DataFrame, records: list) -> list[bool]:
    """Whether each model_recs_batch record's names are its ids' catalog
    names (None for an id absent from the catalog)."""
    ids = catalog["MAL_ID"].to_numpy()
    names = catalog["Name"].to_numpy(object)
    out = []
    for rec in records:
        want = np.asarray(rec["anime_ids"], np.int64)
        at = np.clip(np.searchsorted(ids, want), 0, len(ids) - 1)
        known = ids[at] == want
        out.append(rec["names"] == [names[a] if k else None for a, k in zip(at, known)])
    return out


def check_answers(cfg: dict, inputs: Inputs, model, sample: list, k: int, device,
                  faults: tuple = ()) -> dict:
    """The check's numbers over the sampled answered requests: the widest
    gap of an answer (reference_blocked.answer_gap, compare.answer_gap's
    number) and the count of wrong answers (a row it may not hold, a wrong
    name, a missing query). ``faults`` plants faults in the answers before
    the check (tests and calibration): "half_batch" drops the second half
    of each request's records, "watched" serves a user's watched row in
    place of its last answer."""
    user_table, item_table = model.user_emb, model.anime_emb
    head = reference.head_affine({name: getattr(model, name) for name in
                                  ("dense_w", "dense_b", "bn_gamma", "bn_beta",
                                   "moving_mean", "moving_var")})
    present = (inputs.catalog["MAL_ID"].to_numpy() - datagen.ANIME_ID_BASE) \
        // datagen.ANIME_ID_STRIDE
    in_catalog = torch.zeros(cfg["n_anime"], dtype=torch.bool, device=device)
    in_catalog[torch.as_tensor(present, device=device)] = True
    gap, wrong, worst = 0.0, 0, None
    for route in ("similar_users_batch", "model_recs_batch"):
        reqs = [(path, json.loads(body)) for path, body in sample
                if path[1:].split("?")[0] == route]
        records, asked_rows = [], []
        for path, recs in reqs:
            asked = _asked_rows(path)
            recs = plant(recs, asked, inputs, faults)
            if len(recs) != len(asked):
                wrong += len(asked)
                continue
            records += recs
            asked_rows.append(asked)
        if not records:
            continue
        asked_rows = np.concatenate(asked_rows)
        asked_ids = datagen.user_ids(asked_rows).tolist()
        rows, scores, ok = served(records, asked_ids, route)
        if route == "model_recs_batch":
            ok = [a and b for a, b in zip(ok, names_match(inputs.catalog, records))]
            live = reference_blocked.Live(cfg["n_anime"], in_catalog,
                                          [inputs.watched(r) for r in asked_rows])
        else:
            live = reference_blocked.Live(cfg["n_users"], None, [[r] for r in asked_rows])
        pad = np.full((len(rows), max(k, max(map(len, rows)))), -1, np.int64)
        for i, r in enumerate(rows):
            pad[i, :len(r)] = r
        queries = reference.normalize(table_rows(user_table, asked_rows, device))
        best, got = reference_blocked.scan(
            user_table if route == "similar_users_batch" else item_table, queries, pad, live,
            k, head if route == "model_recs_batch" else None)
        for i in range(len(records)):
            g = (reference_blocked.answer_gap(rows[i], scores[i], got, best, live, i, k)
                 if ok[i] else math.inf)
            if math.isinf(g):
                wrong += 1
                print(f"[portbench] wrong answer: {route} user {asked_ids[i]}: "
                      f"{str(records[i])[:600]}", flush=True)
            elif g > gap:
                gap, worst = g, (route, asked_ids[i])
        del best, got, queries
    user_table.release()
    item_table.release()
    print(f"[portbench] widest gap {gap!r}: {worst}", flush=True)
    return {"score_gap": gap, "wrong_answers": float(wrong)}


def plant(records: list, asked: np.ndarray, inputs: Inputs, faults: tuple) -> list:
    """``records`` with the named faults planted (check_answers)."""
    if "half_batch" in faults:
        records = records[:len(records) // 2]
    out = []
    for rec, row in zip(records, asked):
        rec = dict(rec)
        if "anime_ids" in rec:
            ids, vals = list(rec["anime_ids"]), list(rec["predictions"])
            names = list(rec["names"])
            watched = inputs.watched(row)
            if "watched" in faults and len(ids) and len(watched):
                ids[-1] = int(datagen.anime_ids(watched[:1])[0])
            rec.update(anime_ids=ids, predictions=vals, names=names)
        out.append(rec)
    return out


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
                "least_scan_s": base.scan_work(cfg, raw["inputs"], raw["spans"], mix["k"]),
                "scan_work": raw["scan_work"]}
    tracer = raw["tracer"]
    if tracer:
        t = tracer.trace
        readings.update(device_op_s=t.op_s, busy_s=t.busy_s, traced_window_s=t.window_s,
                        device_ops=t.n_ops, scan_kernel_s=graph_kernel_seconds(tracer))
    failed = len(raw["records"]) - len(raw["answered"])
    engine: dict = {}
    for method, t0, t1, _ in raw["spans"]:
        engine.setdefault(method, []).append(1e3 * (t1 - t0))
    request_ms = [1e3 * r[2] for r in raw["records"]]
    print("[portbench] window " + json.dumps({
        "requests": len(request_ms), "request_mean_ms": float(np.mean(request_ms)),
        "engine_mean_ms": {m: float(np.mean(v)) for m, v in engine.items()},
        "captures_in_window": g1["captures"] - g0["captures"], "graphs": g1["graphs"],
        "pool_mb": g1["pool_mb"], "scan_work": raw["scan_work"],
        "scan_kernel_s": readings.get("scan_kernel_s"), "tables": raw["tables"]}), flush=True)
    return Outcome(end_to_end={"batch_queries_per_s": queries / window_s},
                   readings=readings, checks=checks_of(numbers, cell.limits),
                   attempted=len(raw["records"]), failed=failed,
                   memory_peak_bytes=raw["peak"], trace=tracer.trace if tracer else None)


def calibrate(cell, device, seed: int, control: bool) -> dict:
    """One seed's readings of the check's numbers through a short window at
    the cell's load: the sound program's, the half-batch fault's (planted in
    the sound program's answers) and, with ``control``, the control's (the
    program with its own bf16 retrieval tables)."""
    cell.seed = seed
    raw, sound = measure(cell, device, harness.Clock())
    out = {"sound": sound,
           "half_batch": check_answers(cell.config, raw["inputs"], raw["model"], raw["sample"],
                                       cell.traffic["k"], device, faults=("half_batch",))}
    if control:
        _, out["control"] = measure(cell, device, harness.Clock(), retrieval_dtype="bf16")
    return out
