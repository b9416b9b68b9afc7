"""The port's span recorder (utils/profiling.span) and the spans the program
opens with it: the request path through the HTTP server on a tiny context,
the scan-graph cache, the trainer's device epoch and the Chrome trace of
profiling.trace, on the CPU; ``cuda``-marked, the epoch's and the scan's
graph replays on the card."""

import json
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import defaultdict

import numpy as np
import pytest
import torch

from anime_recommendations_tpu_torch.config import Config
from anime_recommendations_tpu_torch.data.catalog import Catalog
from anime_recommendations_tpu_torch.data.dataset import RatingsDataset
from anime_recommendations_tpu_torch.data.preprocess import preprocess_ratings
from anime_recommendations_tpu_torch.data.vocab import build_vocab, encode_frame
from anime_recommendations_tpu_torch.models.two_tower import params_from_numpy
from anime_recommendations_tpu_torch.ops import topk
from anime_recommendations_tpu_torch.ops.scan_graph import ScanGraphs
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.serve.api import make_server
from anime_recommendations_tpu_torch.train.trainer import Trainer
from anime_recommendations_tpu_torch.utils import profiling
from anime_recommendations_tpu_torch.utils.profiling import span, spans_start, spans_stop

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    spans_stop()
    yield
    spans_stop()


def children(spans):
    """Span index -> the indices of its children, in opening order."""
    out = defaultdict(list)
    for i, s in enumerate(spans):
        if s.parent >= 0:
            out[s.parent].append(i)
    return out


def assert_children_within(spans):
    """Each span is closed, lies within its parent on its parent's thread and
    root, and its children's times add up within its own."""
    kids = children(spans)
    for i, s in enumerate(spans):
        assert s.end_ns is not None and s.end_ns >= s.start_ns, s
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)
            assert (s.thread, s.root) == (p.thread, p.root), (p, s)
        else:
            assert s.root == i
        assert sum(spans[c].end_ns - spans[c].start_ns for c in kids[i]) <= s.end_ns - s.start_ns


# ---- the recorder ------------------------------------------------------------------


def test_nesting_gives_parents_and_request_ids():
    spans_start()
    with span("a") as a:
        a.annotate(route="/x", status=200)
        with span("b"):
            with span("c"):
                pass
        with span("d"):
            pass
    with span("e"):
        pass
    spans = spans_stop()
    assert [s.name for s in spans] == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1]
    assert [s.root for s in spans] == [0, 0, 0, 0, 4]
    assert spans[0].attrs == {"route": "/x", "status": 200}
    assert all(s.attrs is None for s in spans[1:])
    assert {s.thread for s in spans} == {threading.get_native_id()}
    assert_children_within(spans)


def test_spans_from_more_threads_than_cores_are_all_kept_with_their_parents():
    n_threads, reps = 12, 50
    barrier = threading.Barrier(n_threads)

    def work(t):
        barrier.wait()
        for r in range(reps):
            with span(f"root.{t}") as s:
                s.annotate(rep=r)
                with span(f"child.{t}"):
                    with span(f"leaf.{t}"):
                        pass
                with span(f"child.{t}"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)          # switch threads as often as the interpreter can
    try:
        spans_start()
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        spans = spans_stop()
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert len(spans) == n_threads * reps * 4
    assert len({s.thread for s in spans}) == n_threads
    kids = children(spans)
    for i, s in enumerate(spans):
        t = s.name.split(".")[1]
        if s.name.startswith("root."):
            assert s.parent == -1 and s.root == i
            assert [spans[c].name for c in kids[i]] == [f"child.{t}"] * 2
        elif s.name.startswith("child."):
            assert spans[s.parent].name == f"root.{t}"
        else:
            assert spans[s.parent].name == f"child.{t}"
    assert sorted(s.attrs["rep"] for s in spans if s.attrs) == sorted(list(range(reps)) * n_threads)
    assert_children_within(spans)


def test_off_records_nothing_and_returns_one_null_context():
    first = span("a")
    assert span("b") is first
    with first as s:
        s.annotate(x=1)
        with span("c"):
            pass
    assert spans_stop() == []
    spans_start()
    assert span("a") is not first
    spans_stop()
    assert span("a") is first


def test_a_span_open_when_the_recorder_starts_is_no_parent_and_one_open_at_stop_has_no_end():
    spans_start()
    outer = span("outer")
    outer.__enter__()
    spans_start()                       # a new session while "outer" is open
    with span("inner"):
        pass
    late = span("late")
    late.__enter__()
    spans = spans_stop()
    late.__exit__(None, None, None)
    outer.__exit__(None, None, None)
    assert [(s.name, s.parent, s.root) for s in spans] == [("inner", -1, 0), ("late", -1, 1)]
    assert spans[0].end_ns is not None and spans[1].end_ns is None


# ---- the request path --------------------------------------------------------------


@pytest.fixture(scope="module")
def ctx(ratings_frame, anime_catalog_frame, synopses_frame):
    clean, _ = preprocess_ratings(ratings_frame, num_reviews=50)
    vocab = build_vocab(clean)
    catalog = Catalog.from_frames(anime_catalog_frame, synopses_frame)
    rng = np.random.default_rng(11)
    arrays = {
        "user_emb": rng.uniform(-0.05, 0.05, (vocab.n_users, 16)).astype(np.float32),
        "anime_emb": rng.uniform(-0.05, 0.05, (vocab.n_anime, 16)).astype(np.float32),
        "dense_w": np.float32(2.0), "dense_b": np.float32(0.1),
        "bn_gamma": np.float32(1.1), "bn_beta": np.float32(-0.1),
        "moving_mean": np.float32(0.05), "moving_var": np.float32(0.8),
    }
    return RecContext.build(params_from_numpy(arrays, "cpu"), vocab, catalog,
                            encode_frame(clean, vocab), device="cpu")


def route_paths(ctx):
    """One request of every route, and three that fail (404, 400, 404)."""
    users = [int(u) for u in ctx.vocab.user_ids[:5]]
    name = str(ctx.catalog.anime["Name"].iloc[3])
    names = "|".join(str(n) for n in ctx.catalog.anime["Name"].iloc[[3, 7, 9]])
    ids = ",".join(map(str, users))
    return [
        ("/health", None),
        (f"/similar_anime?name={name}&k=5", "similar_anime"),
        (f"/similar_users?user_id={users[0]}&k=4", "similar_users"),
        (f"/user_prefs?user_id={users[1]}", "user_prefs"),
        (f"/user_recs?user_id={users[2]}&k=5", "user_recs"),
        (f"/model_recs?user_id={users[3]}&k=5", "model_recs"),
        (f"/similar_anime_batch?names={names}&k=5", "similar_anime_batch"),
        (f"/model_recs_batch?user_ids={ids}&k=5", "model_recs_batch"),
        (f"/similar_users_batch?user_ids={ids}&k=4&faves=0", "similar_users_batch"),
        (f"/similar_users_batch?user_ids={ids}&k=4", "similar_users_batch"),
        ("/no_such_route", None),
        ("/model_recs?user_id=oops", None),
        ("/model_recs?user_id=-7", "model_recs"),
    ]


def serve(ctx, paths, recorder: bool):
    """[(status, body)] of each path in turn through a fresh server, and the
    spans recorded (None with the recorder off). The server's request
    threads are joined before the recorder stops, so every span is closed."""
    from urllib.parse import quote

    server = make_server(ctx, Config(), host="127.0.0.1", port=0)
    server.daemon_threads = False        # server_close() joins the request threads
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    out = []
    if recorder:
        spans_start()
    try:
        for path in paths:
            url = f"http://127.0.0.1:{server.server_address[1]}{quote(path, safe='/?=&,|-')}"
            try:
                with urllib.request.urlopen(url, timeout=60) as resp:
                    out.append((resp.status, resp.read()))
            except urllib.error.HTTPError as e:
                out.append((e.code, e.read()))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        spans = spans_stop() if recorder else None
    return out, spans


# The children each span of a request holds, by name, on the CPU (no scan
# graphs there, so scan.call holds the host staging and the read-back).
TREE = {
    "engine.similar_anime": ["recommend.encode", "recommend.masks", "scan.call", "recommend.join"],
    "engine.similar_users": ["recommend.encode", "scan.call", "recommend.join"],
    "engine.user_prefs": [],
    "engine.user_recs": ["recommend.encode", "scan.call", "recommend.join"],
    "engine.model_recs": ["recommend.encode", "recommend.masks", "scan.call", "recommend.join"],
    "engine.similar_anime_batch": ["recommend.encode", "recommend.masks", "scan.call",
                                   "recommend.join"],
    "engine.model_recs_batch": ["recommend.encode", "recommend.masks", "scan.call",
                                "recommend.join"],
    "engine.similar_users_batch": ["recommend.encode", "scan.call", "recommend.join"],
    "scan.call": ["scan.stage", "scan.readback"],
}


def test_each_request_is_a_tree_of_spans_within_its_root(ctx):
    paths = route_paths(ctx)
    answers, spans = serve(ctx, [p for p, _ in paths], recorder=True)
    assert [a[0] for a in answers] == [200] * 10 + [404, 400, 404]
    assert_children_within(spans)
    kids = children(spans)
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["serve.request"] * len(paths)
    for (path, method), i, (status, _) in zip(paths, roots, answers):
        assert spans[i].attrs == {"route": path.split("?")[0], "status": status}
        assert [spans[c].name for c in kids[i]] == ([] if method is None
                                                    else [f"engine.{method}"])
        if status == 200:
            for j, s in enumerate(spans):
                if s.root == i and s.name in TREE:
                    assert [spans[c].name for c in kids[j]] == TREE[s.name], path
    # The unknown user's request fails in recommend.encode, which closes all the same.
    (engine,) = kids[roots[-1]]
    assert [spans[c].name for c in kids[engine]] == ["recommend.encode"]


def test_every_route_answers_the_same_with_the_recorder_on_and_off(ctx):
    paths = [p for p, _ in route_paths(ctx)]
    off, none = serve(ctx, paths, recorder=False)
    on, spans = serve(ctx, paths, recorder=True)
    assert none is None and len(spans) > len(paths)
    assert on == off                    # every status and every body, byte for byte


def test_scan_graph_cache_spans_the_lock_wait_and_the_eager_body():
    graphs = ScanGraphs(capacity=2)
    table = torch.nn.functional.normalize(torch.randn(64, 8), dim=1)
    body = lambda queries, mask, exclude, head: topk.masked_topk(table, queries, 3)  # noqa: E731
    inputs = {"queries": table[:2], "mask": None, "exclude": None, "head": None}
    spans_start()
    with span("caller"):
        vals, _ = graphs.run(("k",), body, inputs, torch.device("cpu"))
    spans = spans_stop()
    assert [(s.name, s.parent) for s in spans] == [("caller", -1), ("scan.lock_wait", 0),
                                                   ("scan.eager", 0)]
    assert spans[1].end_ns <= spans[2].start_ns
    assert vals.shape == (2, 3) and graphs.misses == 1
    assert_children_within(spans)


# ---- the epoch loop ----------------------------------------------------------------


def tiny_training(device):
    rng = np.random.default_rng(3)
    n_users, n_anime, n = 60, 30, 2400
    cols = (rng.integers(0, n_users, n).astype(np.int32),
            rng.integers(0, n_anime, n).astype(np.int32), rng.uniform(size=n).astype(np.float32))
    train = RatingsDataset(*(c[:2000] for c in cols))
    hold = RatingsDataset(*(c[2000:] for c in cols))
    trainer = Trainer(embedding_size=8, batch_size=256, device_loop=True, verbose=False,
                      seed=4, device=device)
    state = trainer._init_state(torch.Generator().manual_seed(4), n_users, n_anime)
    return trainer, state, trainer._stage_device(train, hold)


def test_device_epoch_is_one_train_epoch_holding_its_waits():
    trainer, state, staged = tiny_training("cpu")
    spans_start()
    for epoch in range(2):
        state, loss_sum, _, w_total, vl, _ = trainer._device_epoch(staged, state, epoch, 1e-3)
    spans = spans_stop()
    assert [s.name for s in spans] == ["train.epoch", "epoch.wait", "epoch.wait"] * 2
    assert [s.parent for s in spans] == [-1, 0, 0, -1, 3, 3]
    assert [s.attrs for s in spans if s.name == "train.epoch"] == [{"epoch": 0}, {"epoch": 1}]
    assert np.isfinite(loss_sum) and w_total == 2000 and isinstance(vl, float)
    assert_children_within(spans)


# ---- profiling.trace ---------------------------------------------------------------


def written_trace(tmp_path):
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    return json.loads(files[0].read_text())["traceEvents"]


def test_trace_writes_a_second_threads_spans_into_the_chrome_trace(tmp_path):
    tids = []

    def worker():
        tids.append(threading.get_native_id())
        with span("worker.request") as s:
            s.annotate(route="/x")
            with span("worker.step"):
                torch.ones(64).sum()

    with profiling.trace(tmp_path / "trace"):
        th = threading.Thread(target=worker)
        th.start()
        th.join()
        torch.ones(64).sum()                       # the profiler's own, on this thread
    assert span("after") is span("again")          # the recorder is off again
    events = written_trace(tmp_path)
    mine = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(mine) == {"worker.request", "worker.step"}
    req, step = mine["worker.request"], mine["worker.step"]
    assert req["pid"] == step["pid"] == profiling.SPAN_PID
    assert req["tid"] == step["tid"] == tids[0]
    assert req["args"] == {"route": "/x", "span": 0, "parent": -1, "root": 0}
    assert step["args"] == {"span": 1, "parent": 0, "root": 0}
    assert req["ts"] <= step["ts"] and step["ts"] + step["dur"] <= req["ts"] + req["dur"]
    assert [e["args"] for e in events if e.get("ph") == "M"
            and e.get("pid") == profiling.SPAN_PID] == [{"name": "program spans"}]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_trace_puts_spans_on_the_profilers_clock(tmp_path):
    """A span inside a main-thread annotation lands inside it on the
    trace's clock, within a millisecond at each end."""
    with profiling.trace(tmp_path / "trace"):
        for i in range(3):
            with torch.profiler.record_function(f"block.{i}"):
                with span(f"block.{i}"):
                    time.sleep(0.02)
    events = written_trace(tmp_path)
    for i in range(3):
        (mark,) = [e for e in events if e["name"] == f"block.{i}"
                   and e.get("cat") == "user_annotation"]
        (mine,) = [e for e in events if e["name"] == f"block.{i}"
                   and e.get("cat") == "program_span"]
        start_gap = mine["ts"] - mark["ts"]
        end_gap = (mark["ts"] + mark["dur"]) - (mine["ts"] + mine["dur"])
        assert 0 <= start_gap < 1e3 and 0 <= end_gap < 1e3, (start_gap, end_gap)


# ---- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_epoch_launches_and_evaluates_under_its_spans_on_the_card(cuda):
    trainer, state, staged = tiny_training(cuda)
    spans_start()
    for epoch in range(2):
        state, loss_sum, *_ = trainer._device_epoch(staged, state, epoch, 1e-3)
    spans = spans_stop()
    assert [s.name for s in spans] == ["train.epoch", "epoch.chunk", "epoch.wait",
                                       "epoch.eval", "epoch.wait"] * 2
    assert [s.parent for s in spans] == [-1, 0, 0, 0, 0, -1, 5, 5, 5, 5]
    assert [s.attrs for s in spans if s.name == "epoch.chunk"] == [{"steps": 8}] * 2
    assert np.isfinite(loss_sum)
    assert_children_within(spans)


@pytest.mark.cuda
def test_chunked_device_epoch_replays_under_chunk_spans_on_the_card(cuda, monkeypatch):
    """An epoch of 8 steps in chunks of 3: three ``epoch.chunk`` spans, each
    annotated with its steps."""
    from anime_recommendations_tpu_torch.train import device_loop as dl

    monkeypatch.setattr(dl, "CHUNK_STEPS", 3)
    trainer, state, staged = tiny_training(cuda)
    spans_start()
    for epoch in range(2):
        state, loss_sum, *_ = trainer._device_epoch(staged, state, epoch, 1e-3)
    spans = spans_stop()
    assert [s.name for s in spans] == ["train.epoch", *["epoch.chunk"] * 3, "epoch.wait",
                                       "epoch.eval", "epoch.wait"] * 2
    assert [s.parent for s in spans] == [-1, *[0] * 6, -1, *[7] * 6]
    assert [s.attrs for s in spans if s.name == "epoch.chunk"] == [
        {"steps": 3}, {"steps": 3}, {"steps": 2}] * 2
    assert np.isfinite(loss_sum)
    assert_children_within(spans)


@pytest.mark.cuda
def test_scan_call_replays_its_graph_under_its_spans_on_the_card(cuda):
    graphs = ScanGraphs(capacity=2)
    table = torch.nn.functional.normalize(torch.randn(4096, 32, device=cuda), dim=1)
    spans_start()
    for _ in range(3):
        vals, idx = topk.host_topk(topk.cosine_topk, table, table[:16], 10, graphs=graphs)
    spans = spans_stop()
    calls = [i for i, s in enumerate(spans) if s.name == "scan.call"]
    kids = children(spans)
    assert [[spans[c].name for c in kids[i]] for i in calls] == [
        ["scan.stage", "scan.lock_wait", body, "scan.readback"]
        for body in ("scan.eager", "scan.capture", "scan.replay")]
    assert isinstance(vals, np.ndarray) and idx.shape == (16, 10)
    assert (graphs.hits, graphs.misses, graphs.captures) == (1, 2, 1)
    assert_children_within(spans)
