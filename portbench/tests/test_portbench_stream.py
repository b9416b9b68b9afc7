"""The streamed batch cell (kinds/closed_batch_stream.py) at tiny sizes on the
CPU: a whole run is correct; the blocked reference gives the whole table's
check at any block size; the check fails each planted fault."""

import json
import math

import numpy as np
import pytest
import torch

from portbench import compare, datagen, datagen_stream, harness, reference, reference_blocked
from pb_tiny import CPU

NAME = "amazon23-serve-batch"
TINY = dict(n_users=3000, n_anime=2000, n_ratings=12000, embedding_size=16)


def tiny_cell(seed=2**31 + 11, seconds=1.0, trace=False):
    cell = harness.Cell.load(NAME, seed=seed, seconds=seconds, trace=trace)
    cell.config = dict(cell.config, **TINY)
    cell.traffic = dict(cell.traffic, ids_per_request=64)
    return cell


@pytest.fixture
def small_blocks(monkeypatch):
    """Blocks of rows that do not divide the tables: every edge is crossed."""
    monkeypatch.setattr(datagen_stream, "BLOCK_ROWS", 700)
    monkeypatch.setattr(reference_blocked, "BLOCK_ROWS", 333)


def test_whole_run_is_correct(small_blocks):
    from portbench.run import result_line, run_cell

    cell = tiny_cell()
    clock = harness.Clock()
    clock.mark("process")
    out = run_cell(cell, CPU, clock)
    line = result_line(cell, out, CPU, clock)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"batch_queries_per_s", "setup_s"}
    assert set(clock.parts) == {"process", "data", "catalog", "context", "warm_up"}


def test_the_parent_port_fails_at_once(monkeypatch):
    from anime_recommendations_tpu_torch.ops import scan_graph

    kind = harness.kind_module("closed_batch_stream")
    monkeypatch.delattr(scan_graph.ScanGraphs, "scan_report")
    with pytest.raises(RuntimeError, match="scan_report"):
        kind.measure(tiny_cell(), CPU, harness.Clock())


def test_ratings_keep_the_configuration(small_blocks):
    cfg = dict(harness.Cell.load(NAME).config, **TINY)
    r = datagen_stream.ratings(cfg, 5, CPU)
    assert len(r.users) == cfg["n_ratings"] and r.offsets[-1] == cfg["n_ratings"]
    keys = r.users * cfg["n_anime"] + r.anime
    assert torch.equal(keys, torch.unique(keys))            # sorted, no pair twice
    assert r.rating.min() == 0 and r.rating.max() == 1
    again = datagen_stream.ratings(cfg, 5, CPU)
    assert torch.equal(again.anime, r.anime) and torch.equal(again.rating, r.rating)
    table = datagen_stream.SeededTable(1500, 8, 3, 0, CPU)
    whole = table[0:1500]
    assert torch.equal(table[650:1401], whole[650:1401]) and whole.abs().max() <= 0.05


@pytest.mark.parametrize("block_rows", [1, 7, 333, 2000, 5000])
@pytest.mark.parametrize("head", [False, True])
def test_blocked_reference_is_the_whole_tables_check(block_rows, head):
    g = torch.Generator().manual_seed(block_rows)
    n, d, k = 2000, 16, 10
    table = torch.rand(n, d, generator=g) - 0.5
    queries = reference.normalize(torch.rand(6, d, generator=g) - 0.5)
    shared = torch.rand(n, generator=g) > 0.3
    excluded = [np.asarray([j * 3, 7, 1999]) for j in range(6)]
    h = (1.7, -0.2) if head else None
    full = reference.scores(reference.normalize(table), queries, h)
    live = reference_blocked.Live(n, shared, excluded)
    served = []
    for j in range(6):
        ok = shared.clone()
        ok[torch.as_tensor(excluded[j])] = False
        top = torch.topk(torch.where(ok, full[j], -math.inf), k + 3).indices.numpy()
        served.append(top[[0, 1, 2, 4, 3, 5, 6, 7, 8, 12]] if j % 2 else top[:k])
    pad = np.stack(served)
    best, got = reference_blocked.scan(table, queries, pad, live, k, h, block_rows)
    for j in range(6):
        ok = shared.clone()
        ok[torch.as_tensor(excluded[j])] = False
        scores = full[j, torch.as_tensor(served[j])].numpy() + (1e-6 if j == 4 else 0.0)
        want = compare.answer_gap(served[j], scores, full[j], ok, k)
        # A block's product may sum in another order than the whole
        # table's (a one-row block is a matrix-vector product): an ulp.
        assert reference_blocked.answer_gap(served[j], scores, got, best, live, j, k) == \
            pytest.approx(want, abs=2e-7)
        assert want > 0 if j % 2 or j == 4 else want == 0
    bad = served[0].copy()
    bad[-1] = excluded[0][1]
    assert math.isinf(reference_blocked.answer_gap(bad, scores, got, best, live, 0, k))


def sound_sample(cell):
    kind = harness.kind_module("closed_batch_stream")
    raw, numbers = kind.measure(cell, CPU, harness.Clock())
    assert numbers["wrong_answers"] == 0 and numbers["score_gap"] <= cell.limits["score_gap"]
    return kind, raw


def test_check_fails_each_planted_fault(small_blocks):
    cell = tiny_cell()
    kind, raw = sound_sample(cell)
    args = (cell.config, raw["inputs"], raw["model"], raw["sample"], cell.traffic["k"], CPU)
    for fault in ("half_batch", "watched"):
        numbers = kind.check_answers(*args, faults=(fault,))
        assert not compare.verdict(numbers, cell.limits), (fault, numbers)
    assert compare.verdict(kind.check_answers(*args), cell.limits)


def test_check_fails_a_row_dropped_at_a_blocks_edge(small_blocks, monkeypatch):
    """An answer that lacks its best row, where that row opens a block of
    the reference: the gap to the reference's best shows it."""
    cell = tiny_cell()
    kind, raw = sound_sample(cell)
    path, body = next((p, b) for p, b in raw["sample"] if p.startswith("/similar_users_batch"))
    records = json.loads(body)
    rec = records[0]
    asked = int(rec["query"])
    row = (asked - datagen.USER_ID_BASE) // datagen.USER_ID_STRIDE
    model = raw["model"]
    table = model.user_emb[0:cell.config["n_users"]]
    scores = reference.scores(reference.normalize(table),
                              reference.normalize(table[row:row + 1]))[0]
    scores[row] = -math.inf
    top = torch.topk(scores, cell.traffic["k"] + 1).indices.numpy()
    assert top[0] > 0
    monkeypatch.setattr(reference_blocked, "BLOCK_ROWS", int(top[0]))   # the best opens block 1
    rec["similar_users"] = datagen.user_ids(top[1:]).tolist()
    rec["similarities"] = scores[torch.as_tensor(top[1:])].tolist()
    sample = [(path, json.dumps(records))]
    numbers = kind.check_answers(cell.config, raw["inputs"], model, sample,
                                 cell.traffic["k"], CPU)
    assert numbers["wrong_answers"] == 0 and numbers["score_gap"] > cell.limits["score_gap"]
