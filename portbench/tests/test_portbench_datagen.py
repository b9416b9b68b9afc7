"""The seeded inputs: deterministic, no repeated (user, anime) pair, the
stated per-user mean, rows ordered by user."""

import numpy as np
import pytest
import torch

from portbench import datagen
from pb_tiny import CPU, TINY


def _cfg(name):
    import json

    from portbench import harness

    cfg = json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())
    return dict(cfg, **TINY[name])


@pytest.mark.parametrize("name", ["anime-7m", "anime-full"])
@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 1])
def test_ratings(name, seed):
    cfg = _cfg(name)
    a, b = datagen.ratings(cfg, seed, CPU), datagen.ratings(cfg, seed, CPU)
    assert torch.equal(a.users, b.users) and torch.equal(a.anime, b.anime)
    assert torch.equal(a.rating, b.rating)
    n = cfg["n_ratings"]
    assert len(a.users) == n and int(a.counts.sum()) == n
    pairs = a.users * cfg["n_anime"] + a.anime
    assert len(torch.unique(pairs)) == n
    assert bool((a.users[1:] >= a.users[:-1]).all())
    assert a.counts.min() >= 1 and a.counts.max() <= cfg["n_anime"]
    assert a.counts.mean() == pytest.approx(n / cfg["n_users"])
    assert float(a.rating.min()) == 0.0 and float(a.rating.max()) == 1.0
    assert not torch.equal(datagen.ratings(cfg, seed + 1, CPU).anime, a.anime)


def test_counts_at_full_scale():
    """The configurations' own counts: the stated means, capped."""
    for n_users, n, mean in ((91_641, 7_000_000, 76.385), (350_000, 109_000_000, 311.43)):
        c = datagen.user_counts(n_users, 17_560, n, 1.1, np.random.default_rng(3))
        assert c.sum() == n and c.max() <= 17_560 and c.min() >= 1
        assert c.mean() == pytest.approx(mean, rel=1e-4)
        assert np.median(c) < 0.7 * c.mean()      # heavy-tailed


def test_weights_and_catalog_deterministic():
    cfg = _cfg("anime-full")
    w1, w2 = datagen.weights(cfg, 9, CPU), datagen.weights(cfg, 9, CPU)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert float(w1["user_emb"].abs().max()) <= 0.05
    c1, s1 = datagen.catalog_frames(cfg, 9)
    c2, _ = datagen.catalog_frames(cfg, 9)
    assert c1.equals(c2)
    assert len(c1) == cfg["n_anime"] - int(cfg["n_anime"] * cfg["assumed"]["missing_from_catalog"])
    assert c1["MAL_ID"].is_unique and set(s1["MAL_ID"]) <= set(c1["MAL_ID"])
