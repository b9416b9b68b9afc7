"""The row-sparse training cell (yahoomusic-train-lazy) on the CPU at tiny
sizes of its own: a run is correct; the control (reference_lazy in
bfloat16), the half-batch fault and the dense-semantics fault (dense Adam's
reference in the program's place) fail its check; a capture inside the
window fails it; a port without chunked epochs fails at once; and the
seeded inputs at the configuration's tiny size keep datagen's invariants.

Epochs of 79 steps run in chunks of 16 here (CHUNK_STEPS set for the test),
as the configuration's 26,281-step epochs run in chunks on the card."""

import json

import numpy as np
import pytest
import torch

from portbench import compare, datagen, harness
from pb_tiny import CPU, run_tiny

NAME = "yahoomusic-train-lazy"
TINY = dict(n_users=2000, n_anime=600, n_ratings=40_000, batch_size=500, test_size=500,
            embedding_size=16)
CHUNK = 16


@pytest.fixture
def chunked(monkeypatch):
    from anime_recommendations_tpu_torch.train import device_loop as dl

    monkeypatch.setattr(dl, "CHUNK_STEPS", CHUNK)
    return dl


def tiny_cell(seed=2**31 + 11):
    cell = harness.Cell.load(NAME, seed=seed, seconds=1.0)
    cell.config = dict(cell.config, **TINY)
    return cell


def test_sound_run_is_correct(chunked):
    out, line = run_tiny(tiny_cell())
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in harness.Cell.load(NAME).end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["checks"]["window_captures"] == {"value": 0, "limit": 0}
    # 39,500 train rows in batches of 500: 79 steps, each touching at most
    # 500 users and 500 items.
    assert 0 < out.readings["least_step_s"] < 1e-3


@pytest.mark.parametrize("seed", [3, 2**31 + 4, 2**33 + 5])
def test_control_and_faults_fail(chunked, seed):
    cell = tiny_cell()
    kind = harness.kind_module(cell.traffic["kind"])
    out = kind.calibrate(cell, CPU, seed, control=True)
    assert compare.verdict(out["sound"], cell.limits), out["sound"]
    for name in ("control", "half_batch", "dense"):
        assert not compare.verdict(out[name], cell.limits), (name, out[name])


def test_a_capture_inside_the_window_fails(chunked, monkeypatch):
    counts = iter(range(100))
    monkeypatch.setattr(chunked, "graph_report", lambda: {"captured": next(counts)})
    _, line = run_tiny(tiny_cell())
    assert line["checks"]["window_captures"]["value"] > 0 and not line["correct"]


def test_a_port_without_chunked_epochs_fails_at_once(monkeypatch):
    from anime_recommendations_tpu_torch.train import device_loop as dl

    monkeypatch.delattr(dl, "graph_report")
    with pytest.raises(RuntimeError, match="no chunked epochs"):
        run_tiny(tiny_cell())


def test_chunk_gaps_are_read_within_each_epoch():
    from anime_recommendations_tpu_torch.utils.profiling import Span

    kind = harness.kind_module("train_epochs_lazy")
    spans = [Span("train.epoch", 0, 100, 1, -1, 0, None),
             Span("epoch.chunk", 10, 20, 1, 0, 0, {"steps": 3}),
             Span("epoch.chunk", 25, 40, 1, 0, 0, {"steps": 3}),
             Span("epoch.chunk", 47, 60, 1, 0, 0, {"steps": 2}),
             Span("epoch.wait", 60, 70, 1, 0, 0, None),
             Span("train.epoch", 200, 300, 1, -1, 5, None),
             Span("epoch.chunk", 210, 220, 1, 5, 5, {"steps": 3})]
    assert kind.chunk_gaps(spans) == {"chunk_gap_s": 12e-9, "chunk_gaps": 2}
    assert kind.chunk_gaps([]) == {"chunk_gap_s": 0.0, "chunk_gaps": 0}


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_ratings_at_the_tiny_size(seed):
    cfg = json.loads((harness.BENCH / "configs" / "yahoomusic-kddcup11.json").read_text())
    cfg = dict(cfg, **TINY)
    a, b = datagen.ratings(cfg, seed, CPU), datagen.ratings(cfg, seed, CPU)
    assert torch.equal(a.users, b.users) and torch.equal(a.anime, b.anime)
    assert torch.equal(a.rating, b.rating)
    n = cfg["n_ratings"]
    assert len(a.users) == n and int(a.counts.sum()) == n
    assert len(torch.unique(a.users * cfg["n_anime"] + a.anime)) == n
    assert bool((a.users[1:] >= a.users[:-1]).all())
    assert a.counts.min() >= 1 and a.counts.max() <= cfg["n_anime"]
    assert float(a.rating.min()) == 0.0 and float(a.rating.max()) == 1.0


def test_counts_at_the_configurations_size():
    """The configuration's own counts (a third of the source's ratings over
    its every user and item): the stated mean, capped, heavy-tailed."""
    c = datagen.user_counts(1_000_990, 624_961, 87_600_000, 1.1, np.random.default_rng(3))
    assert c.sum() == 87_600_000 and c.max() <= 624_961 and c.min() >= 1
    assert c.mean() == pytest.approx(87.513, rel=1e-4)
    assert np.median(c) < 0.7 * c.mean()
