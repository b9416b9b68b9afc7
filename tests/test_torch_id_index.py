"""A batch's ids translated at once against indexes built once per context.

The recommend layer translates raw user and anime ids to vocab rows
(RecContext.user_indices, anime_indices, through the vocab's sorters) and
vocab rows to catalog rows (RecContext.catalog_positions, a CSR map), each
index built on first use. Held here against the per-id formulations they
replace, written out below as the oracles: the argsort-per-call ``_encode``
and the pandas ``rows_for_ids`` join of one query at a time. Then the
counters (RecContext.id_index_report, Engine.cache_info) and the spans'
``ids``.
"""

import sys
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from anime_recommendations_tpu_torch.config import Config
from anime_recommendations_tpu_torch.data.catalog import Catalog
from anime_recommendations_tpu_torch.data.preprocess import preprocess_ratings
from anime_recommendations_tpu_torch.data.vocab import Vocab, build_vocab, encode_frame
from anime_recommendations_tpu_torch.models.two_tower import params_from_numpy
from anime_recommendations_tpu_torch.ops.topk import cosine_topk, host_topk
from anime_recommendations_tpu_torch.ops.scoring import score_topk
from anime_recommendations_tpu_torch.recommend import batch
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.serve.api import Engine
from anime_recommendations_tpu_torch.utils import profiling

torch.set_num_threads(2)


# ---- the per-id formulations, as they were ----------------------------------------


def old_encode(table_ids, raw):
    order = np.argsort(table_ids, kind="stable")
    sorted_ids = table_ids[order]
    pos = np.searchsorted(sorted_ids, raw)
    pos = np.clip(pos, 0, len(sorted_ids) - 1)
    found = sorted_ids[pos] == raw
    return np.where(found, order[pos], -1).astype(np.int64)


def old_index(table_ids, raw_id, what):
    idx = int(old_encode(table_ids, np.asarray([raw_id]))[0])
    if idx < 0:
        raise KeyError(f"{what} {raw_id} not in training vocab")
    return idx


def rows_for_ids(catalog, anime_ids):
    by_id = catalog.anime.set_index("anime_id", drop=False)
    ids = pd.Index(anime_ids)
    return by_id.loc[ids[ids.isin(by_id.index)]]


def old_similar_anime_batch(ctx, names, count=10, types=None):
    ids = [ctx.catalog.resolve_query(n) for n in names]
    q_idx = np.asarray([old_index(ctx.vocab.anime_ids, a, "Anime") for a in ids], np.int64)
    mask = ctx.in_catalog_mask()
    if types is not None:
        mask &= ctx.type_mask(types)
    vals, idx = host_topk(cosine_topk, ctx.anime_table(), ctx.anime_vectors(q_idx),
                          k=min(count, ctx.vocab.n_anime), mask=mask, exclude=q_idx,
                          graphs=ctx.scan_graphs, **ctx.topk_kwargs)
    out = []
    for row, name in enumerate(names):
        keep = vals[row] > -1e29
        rows = rows_for_ids(ctx.catalog, ctx.vocab.anime_ids[idx[row][keep]])
        out.append({"query": name, "anime_ids": rows["anime_id"].tolist(),
                    "names": rows["Name"].tolist(),
                    "similarities": vals[row][keep][: len(rows)].tolist()})
    return out


def old_model_recs_batch(ctx, user_ids, n_recs=10, types=None):
    user_idx = np.asarray([old_index(ctx.vocab.user_ids, u, "User") for u in user_ids], np.int64)
    shared = ctx.in_catalog_mask()
    if types is not None:
        shared &= ctx.type_mask(types)
    watched_masks = [ctx.watched_mask(int(u)) for u in user_ids]
    buffer = max(int(m.sum()) for m in watched_masks)
    vals, idx = host_topk(score_topk, ctx.anime_table(), ctx.user_vectors(user_idx),
                          ctx.head, k=min(n_recs + buffer, ctx.vocab.n_anime), mask=shared,
                          graphs=ctx.scan_graphs, **ctx.topk_kwargs)
    out = []
    for row, uid in enumerate(user_ids):
        keep = (vals[row] > -1e29) & ~watched_masks[row][np.clip(idx[row], 0, None)]
        rows = rows_for_ids(ctx.catalog, ctx.vocab.anime_ids[idx[row][keep][:n_recs]])
        out.append({"user_id": int(uid), "anime_ids": rows["anime_id"].tolist(),
                    "names": rows["Name"].tolist(),
                    "predictions": vals[row][keep][: len(rows)].tolist()})
    return out


# ---- fixtures -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def frames(ratings_frame, anime_catalog_frame, synopses_frame):
    clean, _ = preprocess_ratings(ratings_frame, num_reviews=50)
    vocab = build_vocab(clean)
    rng = np.random.default_rng(5)
    arrays = {
        "user_emb": rng.uniform(-0.05, 0.05, (vocab.n_users, 16)).astype(np.float32),
        "anime_emb": rng.uniform(-0.05, 0.05, (vocab.n_anime, 16)).astype(np.float32),
        "dense_w": np.float32(2.0), "dense_b": np.float32(0.1),
        "bn_gamma": np.float32(1.1), "bn_beta": np.float32(-0.1),
        "moving_mean": np.float32(0.05), "moving_var": np.float32(0.8),
    }
    return dict(vocab=vocab, encoded=encode_frame(clean, vocab), arrays=arrays,
                anime=anime_catalog_frame, synopses=synopses_frame)


def make_ctx(frames, anime_raw=None, arrays=None) -> RecContext:
    """A context on a vocab of its own (its counters start at 0)."""
    v = frames["vocab"]
    vocab = Vocab(user_ids=v.user_ids, anime_ids=v.anime_ids)
    catalog = Catalog.from_frames(frames["anime"] if anime_raw is None else anime_raw,
                                  frames["synopses"])
    return RecContext.build(params_from_numpy(arrays or frames["arrays"], "cpu"), vocab,
                            catalog, frames["encoded"], device="cpu")


@pytest.fixture(scope="module")
def dup_ctx(frames):
    """A catalog in which some anime have two or three rows (of other scores,
    so they land apart in the catalog's order) and some trained anime have
    none."""
    raw = frames["anime"]
    vocab_ids = frames["vocab"].anime_ids
    absent = set(vocab_ids[3:60:9].tolist())
    kept = raw[~raw["MAL_ID"].isin(absent)]
    score = pd.to_numeric(kept["Score"], errors="coerce")
    twice = kept.iloc[::4].assign(Score=score.iloc[::4] * 0.5)
    thrice = kept.iloc[1::7].assign(Score=score.iloc[1::7] * 0.7)
    # Every other user's embedding is the mean of its watched anime's, so
    # that its watched anime fill the top of its scan and model_recs_batch
    # reads far into the columns for its unwatched ones.
    arrays = dict(frames["arrays"])
    user_emb = arrays["user_emb"].copy()
    enc = frames["encoded"]
    for u in range(0, len(user_emb), 2):
        user_emb[u] = arrays["anime_emb"][enc["anime"][enc["user"] == u]].mean(0)
    arrays["user_emb"] = user_emb
    ctx = make_ctx(frames, pd.concat([kept, twice, thrice], ignore_index=True), arrays)
    assert ctx.catalog.anime["anime_id"].duplicated().sum() > 10
    assert (~ctx.in_catalog_mask()).sum() >= len(absent)
    return ctx


@pytest.fixture(scope="module")
def shuffled_vocab():
    rng = np.random.default_rng(3)
    return Vocab(user_ids=rng.permutation(np.arange(1000, 1000 + 7 * 5000, 7)),
                 anime_ids=rng.permutation(np.arange(5, 5 + 3 * 900, 3)))


# ---- raw ids to vocab rows ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["user", "anime"])
def test_batch_indices_match_the_per_id_encode(shuffled_vocab, frames, kind):
    """On a vocab in shuffled order, with repeated ids: one batch lookup
    gives the rows the per-id argsort gave, and the vocab's encode keeps -1
    for unknown ids."""
    table = getattr(shuffled_vocab, f"{kind}_ids")
    rng = np.random.default_rng(8)
    known = rng.choice(table, 300)
    known = np.concatenate([known, known[:40], table[:1], table[-1:]])
    ctx = make_ctx(frames)
    ctx = RecContext(vocab=shuffled_vocab, catalog=ctx.catalog, ratings=ctx.ratings,
                     head=ctx.head,
                     anime_scan=ctx.anime_scan, user_scan=ctx.user_scan)
    got = getattr(ctx, f"{kind}_indices")(known.tolist())
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, [old_encode(table, np.asarray([u]))[0] for u in known])
    assert [getattr(ctx, f"{kind}_index")(int(u)) for u in known[:20]] == got[:20].tolist()
    mixed = np.concatenate([known, [-3, 4, table.max() + 1, table.min() - 1]])
    rng.shuffle(mixed)
    encode = getattr(shuffled_vocab, f"encode_{'users' if kind == 'user' else 'anime'}")
    np.testing.assert_array_equal(encode(mixed), old_encode(table, mixed))


@pytest.mark.parametrize("kind,what", [("user", "User"), ("anime", "Anime")])
def test_unknown_id_raises_naming_the_first_in_request_order(frames, kind, what):
    ctx = make_ctx(frames)
    table = getattr(ctx.vocab, f"{kind}_ids")
    ids = [int(table[4]), 999_999_991, int(table[2]), -17]
    with pytest.raises(KeyError) as err:
        getattr(ctx, f"{kind}_indices")(ids)
    with pytest.raises(KeyError) as want:
        [old_index(table, u, what) for u in ids]
    assert err.value.args == want.value.args == (f"{what} 999999991 not in training vocab",)
    with pytest.raises(KeyError, match=f"{what} -17 not in training vocab"):
        getattr(ctx, f"{kind}_index")(-17)


def test_empty_batch(frames):
    ctx = make_ctx(frames)
    for got in (ctx.user_indices([]), ctx.anime_indices([])):
        assert got.shape == (0,) and got.dtype == np.int64
    pos, counts = ctx.catalog_positions(np.empty(0, np.int64))
    assert pos.size == counts.size == 0


# ---- vocab rows to catalog rows -----------------------------------------------------


def test_catalog_positions_match_rows_for_ids(dup_ctx):
    """Every vocab row, absent and duplicated anime included, in a shuffled
    order with repeats: the positions are the rows rows_for_ids gives, in
    its order."""
    rng = np.random.default_rng(2)
    rows = rng.permutation(np.concatenate([np.arange(dup_ctx.vocab.n_anime)] * 2))
    pos, counts = dup_ctx.catalog_positions(rows)
    want = rows_for_ids(dup_ctx.catalog, dup_ctx.vocab.anime_ids[rows])
    anime = dup_ctx.catalog.anime
    pd.testing.assert_frame_equal(anime.iloc[pos].reset_index(drop=True),
                                  want.reset_index(drop=True))
    ends = np.cumsum(counts)
    for j in rng.choice(len(rows), 40, replace=False):
        part = anime.iloc[pos[ends[j] - counts[j]:ends[j]]]
        assert (part["anime_id"] == dup_ctx.vocab.anime_ids[rows[j]]).all()
        assert part.index.is_monotonic_increasing
    assert counts.max() == 3 and (counts == 0).any()


BATCH_CALLS = {
    "plain": dict(),
    "types": dict(types=["TV"]),
    "small_k": dict(k=3),
}


@pytest.mark.parametrize("call", sorted(BATCH_CALLS))
def test_batch_join_matches_the_per_query_join(dup_ctx, call):
    """model_recs_batch and similar_anime_batch on a catalog with repeated
    anime_id rows: the records equal the per-query rows_for_ids join's,
    field for field and value for value (its scores
    ``vals[row][keep][: len(rows)]`` included)."""
    kw = dict(BATCH_CALLS[call])
    k = kw.pop("k", 10)
    users = [int(u) for u in dup_ctx.vocab.user_ids[[0, 5, 9, 40, 41, 77, 5, 2]]]
    got = batch.model_recs_batch(dup_ctx, users, n_recs=k, **kw)
    want = old_model_recs_batch(dup_ctx, users, n_recs=k, **kw)
    assert got == want
    assert any(len(r["anime_ids"]) > k for r in got)        # a repeated id was met
    names = dup_ctx.catalog.anime["Name"].iloc[[0, 3, 11, 30, 3]].tolist()
    got = batch.similar_anime_batch(dup_ctx, names, count=k, **kw)
    assert got == old_similar_anime_batch(dup_ctx, names, count=k, **kw)
    assert any(len(r["anime_ids"]) > len(set(r["anime_ids"])) for r in got)


# ---- counters and spans -------------------------------------------------------------


def test_each_index_is_built_once_and_counts_the_ids_sent(frames):
    ctx = make_ctx(frames)
    engine = Engine(ctx, Config())
    assert ctx.id_index_report() == {"user": {"builds": 0, "ids": 0},
                                     "anime": {"builds": 0, "ids": 0},
                                     "catalog": {"builds": 0, "ids": 0}}
    users = [int(u) for u in ctx.vocab.user_ids[:60]]
    names = ctx.catalog.anime["Name"].iloc[:9].tolist()
    sent = {"user": 0, "anime": 0, "catalog": 0}
    profiling.spans_start()
    try:
        for i in range(6):
            block = users[10 * i:10 * i + 10 - i]
            for rec in engine.model_recs_batch(block, k=5):
                sent["catalog"] += len(rec["anime_ids"])
            engine.similar_users_batch(block, k=4, include_faves=False)
            sent["user"] += 2 * len(block)
            for rec in engine.similar_anime_batch(names[i:], k=4):
                sent["catalog"] += len(rec["anime_ids"])
            sent["anime"] += len(names[i:])
        ctx.user_index(users[0])
        sent["user"] += 1
    finally:
        spans = profiling.spans_stop()
    report = ctx.id_index_report()
    # The default catalog holds each anime once, and the routes scan only
    # anime in it, so each record is one id looked up.
    assert not ctx.catalog.anime["anime_id"].duplicated().any()
    assert report == {kind: {"builds": 1, "ids": n} for kind, n in sent.items()}
    assert engine.cache_info()["id_index"] == report
    assert engine.cache_info()["misses"] == 0
    assert Engine(ctx, Config(), cache_size=0).cache_info() == {"id_index": report}
    for name in ("recommend.encode", "recommend.join"):
        got = [sp.attrs for sp in spans if sp.name == name]
        assert len(got) == 18
        assert got[:3] == [{"ids": 10}, {"ids": 10}, {"ids": 9}]


def test_an_index_shared_by_threads_is_built_once(frames):
    """Many threads translating through one fresh vocab at once: one build
    of each sorter, and not an id lost from the counts."""
    v = frames["vocab"]
    vocab = Vocab(user_ids=v.user_ids, anime_ids=v.anime_ids)
    want = old_encode(v.user_ids, v.user_ids[::-1])
    errors = []

    def work():
        try:
            for _ in range(50):
                np.testing.assert_array_equal(vocab.encode_users(v.user_ids[::-1]), want)
                vocab.encode_anime(v.anime_ids[:7])
        except AssertionError as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert vocab.user_lookup.report() == {"builds": 1, "ids": 16 * 50 * v.n_users}
    assert vocab.anime_lookup.report() == {"builds": 1, "ids": 16 * 50 * 7}
